"""UBJSON (Draft-12) encoder/decoder: the port's copy of the JAX
package's codec (al26_tpu/io/ubjson.py), byte for byte the same wire
format. `dumpb` and `loadb` go through the port's native C++ codec
(io/native/ubjson_native.cpp, built at first use by io.native_build into
al26_tpu_torch/_build/) as the JAX package's go through its own; numpy
payloads and the unoptimized wire form take the Python encoder.
`dumpb_python` and `loadb_python` are the Python codec, the behavioural
specification. `codec()` names the codec in use: "native", or "python"
with the reason where no build can be made here (no C++ compiler, no
Python.h). A compiler that is present and fails raises; nothing falls
back.

The reference serialises its yields store with py-ubjson + zstd because it
is ~25x faster than pickle for its list-heavy payload (al26_nbody.py:41,
242-279, benchmark note :250-252). py-ubjson is not a dependency, so
the format is implemented here from the Draft-12 spec:

  * decode handles the complete spec, including optimized containers
    (`$` type + `#` count) and all numeric widths, so files written by
    py-ubjson (which the reference produces) load unchanged;
  * encode emits spec-conforming output that py-ubjson can read back. Large
    homogeneous float lists — the entire payload of a yields file — are
    written as optimized typed arrays via numpy big-endian buffers.

Supported Python types: None, bool, int, float, str, bytes, list/tuple,
dict (str keys), numpy arrays/scalars.
"""
from __future__ import annotations

import struct
import threading
from io import BytesIO

import numpy as np

from . import native_build

# numeric type markers -> (struct fmt, size)
_INT_TYPES = (
    (b"i", "b", -(2**7), 2**7 - 1),
    (b"U", "B", 0, 2**8 - 1),
    (b"I", ">h", -(2**15), 2**15 - 1),
    (b"l", ">i", -(2**31), 2**31 - 1),
    (b"L", ">q", -(2**63), 2**63 - 1),
)
_NUM_FMT = {
    b"i": ("b", 1), b"U": ("B", 1), b"I": (">h", 2), b"l": (">i", 4),
    b"L": (">q", 8), b"d": (">f", 4), b"D": (">d", 8),
}
_NP_TYPED = {
    b"i": ">i1", b"U": ">u1", b"I": ">i2", b"l": ">i4", b"L": ">i8",
    b"d": ">f4", b"D": ">f8",
}


def _encode_int(buf: BytesIO, v: int) -> None:
    for marker, fmt, lo, hi in _INT_TYPES:
        if lo <= v <= hi:
            buf.write(marker)
            buf.write(struct.pack(fmt, v))
            return
    # out of int64 range: high-precision number (string form)
    s = str(v).encode()
    buf.write(b"H")
    _encode_int(buf, len(s))
    buf.write(s)


def _encode_length(buf: BytesIO, n: int) -> None:
    _encode_int(buf, n)


def _encode_str_body(buf: BytesIO, s: str) -> None:
    raw = s.encode("utf-8")
    _encode_length(buf, len(raw))
    buf.write(raw)


def _is_float_list(v: list) -> bool:
    return len(v) > 0 and all(type(x) is float for x in v)


def _encode(buf: BytesIO, v, optimized: bool) -> None:
    if v is None:
        buf.write(b"Z")
    elif isinstance(v, (bool, np.bool_)):
        # np.bool_ is neither `is True` nor an np.integer — without this
        # branch a numpy-derived flag (arr.any(), a bool column element)
        # fell through to TypeError
        buf.write(b"T" if bool(v) else b"F")
    elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        _encode_int(buf, int(v))
    elif isinstance(v, (float, np.floating)):
        buf.write(b"D")
        buf.write(struct.pack(">d", float(v)))
    elif isinstance(v, str):
        buf.write(b"S")
        _encode_str_body(buf, v)
    elif isinstance(v, (bytes, bytearray)):
        # spec: optimized uint8 array
        buf.write(b"[$U#")
        _encode_length(buf, len(v))
        buf.write(bytes(v))
    elif isinstance(v, np.ndarray):
        _encode_ndarray(buf, v, optimized)
    elif isinstance(v, (list, tuple)):
        if optimized and _is_float_list(v):
            buf.write(b"[$D#")
            _encode_length(buf, len(v))
            buf.write(np.asarray(v, dtype=">f8").tobytes())
        else:
            buf.write(b"[")
            for item in v:
                _encode(buf, item, optimized)
            buf.write(b"]")
    elif isinstance(v, dict):
        buf.write(b"{")
        for k, item in v.items():
            if not isinstance(k, str):
                raise TypeError(f"UBJSON object keys must be str, got {type(k)}")
            _encode_str_body(buf, k)
            _encode(buf, item, optimized)
        buf.write(b"}")
    else:
        raise TypeError(f"cannot UBJSON-encode {type(v)}")


def _encode_ndarray(buf: BytesIO, a: np.ndarray, optimized: bool) -> None:
    if a.ndim == 0:
        _encode(buf, a.item(), optimized)
        return
    if a.ndim > 1:
        buf.write(b"[")
        for row in a:
            _encode_ndarray(buf, row, optimized)
        buf.write(b"]")
        return
    if optimized and a.dtype.kind == "f":
        buf.write(b"[$D#")
        _encode_length(buf, len(a))
        buf.write(a.astype(">f8").tobytes())
    elif optimized and a.dtype.kind in "iu" and a.dtype.itemsize <= 8:
        # UBJSON has no unsigned 32/64 types: pick a SIGNED wire width
        # that holds the dtype's FULL range (uint32 rides int64; uint64
        # above 2^63-1 falls back to per-element encoding, whose scalar
        # path emits high-precision H) — a bare astype('>i4'/'>i8')
        # silently wrapped large unsigned values negative
        if a.dtype.kind == "u" and a.dtype.itemsize == 8 and (
                a.size and int(a.max()) > 2**63 - 1):
            buf.write(b"[")
            for item in a.tolist():
                _encode(buf, item, optimized)
            buf.write(b"]")
            return
        fits_i4 = (a.dtype.itemsize <= 2
                   or (a.dtype.kind == "i" and a.dtype.itemsize <= 4))
        buf.write(b"[$l#" if fits_i4 else b"[$L#")
        _encode_length(buf, len(a))
        buf.write(a.astype(">i4" if fits_i4 else ">i8").tobytes())
    else:
        buf.write(b"[")
        for item in a.tolist():
            _encode(buf, item, optimized)
        buf.write(b"]")


def encode_key(k: str) -> bytes:
    """Encoding of an OBJECT KEY (string body without the 'S' marker,
    Draft-12 §Container/object). Lets callers stream-compose an object:
    b"{" + encode_key(k1) + dumpb(v1) + ... + b"}" is a valid stream that
    decodes identically to dumpb({k1: v1, ...}) — used by the yields
    store's O(N)-memory blob reconstruction (io.yields_store)."""
    buf = BytesIO()
    _encode_str_body(buf, k)
    return buf.getvalue()


# the native codec, loaded at first use (_load_native); _codec names it
_native = None
_codec = None
_lock = threading.Lock()


def _load_native():
    """The native codec module, built and loaded on the first call; None
    where no build can be made here. A failed build raises."""
    global _native, _codec
    if _codec is None:
        with _lock:
            if _codec is None:
                why = native_build.unavailable()
                if why is None:
                    _native = native_build.load()
                    _codec = "native"
                else:
                    _codec = f"python ({why})"
    return _native


def codec() -> str:
    """The codec `dumpb` and `loadb` use in this process: "native", or
    "python (<why no native build>)"."""
    _load_native()
    return _codec


def native_codec():
    """The native codec's (dumpb, loadb); RuntimeError where `codec()` is
    the Python one."""
    native = _load_native()
    if native is None:
        raise RuntimeError(f"the native codec is not in use: {_codec}")
    return native.dumpb, native.loadb


def dumpb(obj, optimized: bool = True) -> bytes:
    """Serialise `obj` to UBJSON bytes (py-ubjson `dumpb` equivalent).
    Routes through the native codec; numpy payloads and the unoptimized
    wire form use the Python encoder."""
    native = _load_native()
    if native is not None and optimized:
        try:
            return native.dumpb(obj)
        except TypeError:
            pass  # unsupported type (e.g. numpy array): the Python encoder
    return dumpb_python(obj, optimized)


def dumpb_python(obj, optimized: bool = True) -> bytes:
    """The Python encoder (the specification the native codec is held
    to)."""
    buf = BytesIO()
    _encode(buf, obj, optimized)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated UBJSON input")
        self.pos += n
        return b

    def marker(self) -> bytes:
        # skip no-ops
        while True:
            m = self.read(1)
            if m != b"N":
                return m


def _decode_number(r: _Reader, marker: bytes):
    fmt, size = _NUM_FMT[marker]
    return struct.unpack(fmt, r.read(size))[0]


def _decode_length(r: _Reader) -> int:
    m = r.marker()
    if m not in (b"i", b"U", b"I", b"l", b"L"):
        raise ValueError(f"invalid length marker {m!r}")
    n = _decode_number(r, m)
    if n < 0:
        raise ValueError("negative container length")
    return n


def _decode_str_body(r: _Reader) -> str:
    n = _decode_length(r)
    return r.read(n).decode("utf-8")


def _decode_value(r: _Reader, marker: bytes):
    if marker == b"Z":
        return None
    if marker == b"T":
        return True
    if marker == b"F":
        return False
    if marker in _NUM_FMT:
        return _decode_number(r, marker)
    if marker == b"C":
        return r.read(1).decode("latin-1")
    if marker == b"S":
        return _decode_str_body(r)
    if marker == b"H":
        s = _decode_str_body(r)
        try:
            return int(s)
        except ValueError:
            return float(s)
    if marker == b"[":
        return _decode_array(r)
    if marker == b"{":
        return _decode_object(r)
    raise ValueError(f"invalid UBJSON marker {marker!r} at {r.pos}")


def _decode_array(r: _Reader):
    m = r.marker()
    typ = None
    count = None
    if m == b"$":
        typ = r.read(1)
        m = r.marker()
        if m != b"#":
            raise ValueError("typed array requires a count")
        count = _decode_length(r)
    elif m == b"#":
        count = _decode_length(r)
        m = None
    if typ is not None:
        if typ == b"U":
            # py-ubjson decodes [$U# payloads as BYTES by default (its
            # no_bytes=False), and our encoder writes bytes that way —
            # returning a list of ints broke the bytes round-trip
            return r.read(count)
        if typ in _NP_TYPED:
            dt = np.dtype(_NP_TYPED[typ])
            arr = np.frombuffer(r.read(count * dt.itemsize), dtype=dt)
            # lists in, lists out: match py-ubjson (returns python lists)
            return arr.tolist()
        if typ == b"T":
            return [True] * count
        if typ == b"F":
            return [False] * count
        if typ == b"Z":
            return [None] * count
        # strings / nested containers: decode item bodies headed by `typ`
        out = []
        for _ in range(count):
            out.append(_decode_value(r, typ))
        return out
    out = []
    if count is not None:
        for _ in range(count):
            out.append(_decode_value(r, r.marker()))
        return out
    while True:
        if m is None:
            m = r.marker()
        if m == b"]":
            return out
        out.append(_decode_value(r, m))
        m = None


def _decode_object(r: _Reader):
    m = r.marker()
    typ = None
    count = None
    if m == b"$":
        typ = r.read(1)
        m = r.marker()
        if m != b"#":
            raise ValueError("typed object requires a count")
        count = _decode_length(r)
    elif m == b"#":
        count = _decode_length(r)
        m = None
    out = {}
    if count is not None:
        for _ in range(count):
            key = _decode_str_body(r)
            marker = typ if typ is not None else r.marker()
            out[key] = _decode_value(r, marker)
        return out
    while True:
        if m is None:
            m = r.marker()
        if m == b"}":
            return out
        # m is the first byte of the key's length marker
        r.pos -= 1
        key = _decode_str_body(r)
        out[key] = _decode_value(r, r.marker())
        m = None


def loadb(data: bytes):
    """Deserialise UBJSON bytes (py-ubjson `loadb` equivalent), through
    the native codec where it is built."""
    native = _load_native()
    if native is not None:
        return native.loadb(data)
    return loadb_python(data)


def loadb_python(data: bytes):
    """The Python decoder (the specification the native codec is held
    to)."""
    r = _Reader(data)
    return _decode_value(r, r.marker())
