"""Readers of a campaign run's files that share no code with the program.

  * zstd frames (RFC 8878): Raw and RLE blocks are decoded here; a frame
    with compressed blocks goes to the `zstandard` package where it imports;
  * the state pickle: every class it names becomes a plain `Record` holding
    what was pickled (so no module of the program, or of the JAX package
    whose class names the files carry, is imported);
  * UBJSON (the yields blob): the draft-12 types, with optimised
    containers ($ type, # count).
"""
from __future__ import annotations

import io
import pickle
import struct

import numpy as np

ZSTD_MAGIC = 0xFD2FB528


def zstd_decode(data: bytes) -> bytes:
    out, pos, n = bytearray(), 0, len(data)
    while pos < n:
        magic = struct.unpack_from("<I", data, pos)[0]
        if 0x184D2A50 <= magic <= 0x184D2A5F:
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            continue
        if magic != ZSTD_MAGIC:
            raise ValueError(f"not a zstd frame: {magic:#x}")
        fhd = data[pos + 4]
        fcs, single, checksum, dict_id = fhd >> 6, (fhd >> 5) & 1, \
            (fhd >> 2) & 1, fhd & 3
        pos += 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_id] \
            + (1 if single else 0, 2, 4, 8)[fcs]
        while True:
            head = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, kind, size = head & 1, (head >> 1) & 3, head >> 3
            if kind == 0:
                out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                out += data[pos:pos + 1] * size
                pos += 1
            else:
                import zstandard

                return zstandard.ZstdDecompressor().decompress(data)
            if last:
                break
        pos += 4 if checksum else 0
    return bytes(out)


class Record:
    """Whatever a pickled object of any class held: its constructor
    arguments (`args`) and its state (`state`, also as attributes where it
    is a dict)."""

    def __init__(self, *args):
        self.args = args
        self.state = None

    def __setstate__(self, state):
        self.state = state
        if isinstance(state, dict):
            self.__dict__.update(state)


class _Reader(pickle.Unpickler):
    SAFE = {("numpy", "ndarray"), ("numpy", "dtype"),
            ("numpy.core.multiarray", "_reconstruct"),
            ("numpy._core.multiarray", "_reconstruct"),
            ("numpy.core.multiarray", "scalar"),
            ("numpy._core.multiarray", "scalar"),
            ("datetime", "datetime"), ("builtins", "set"),
            ("builtins", "frozenset"), ("builtins", "slice"),
            ("collections", "OrderedDict"), ("_codecs", "encode"),
            ("copyreg", "_reconstructor"), ("builtins", "object")}

    def find_class(self, module, name):
        if (module, name) in self.SAFE:
            return super().find_class(module, name)
        return type(name, (Record,), {"module": module})


def load_pickle(data: bytes):
    return _Reader(io.BytesIO(data)).load()


def read_state(path: str):
    """(columns {name: array}, metadata Record) of a state file."""
    with open(path, "rb") as f:
        st = load_pickle(zstd_decode(f.read()))
    cluster = st.cluster
    cols = cluster.state if isinstance(cluster.state, dict) else \
        cluster.__dict__.get("_columns")
    return {k: np.asarray(v) for k, v in cols.items()}, st.metadata


_FIXED = {b"i": ("b", 1), b"U": ("B", 1), b"I": (">h", 2), b"l": (">i", 4),
          b"L": (">q", 8), b"d": (">f", 4), b"D": (">d", 8)}
_NP = {b"i": ">i1", b"U": ">u1", b"I": ">i2", b"l": ">i4", b"L": ">i8",
       b"d": ">f4", b"D": ">f8"}


class _Ubj:
    def __init__(self, data: bytes):
        self.d, self.p = data, 0

    def take(self, k: int) -> bytes:
        out = self.d[self.p:self.p + k]
        if len(out) != k:
            raise ValueError("UBJSON input ended early")
        self.p += k
        return out

    def marker(self) -> bytes:
        m = self.take(1)
        while m == b"N":
            m = self.take(1)
        return m

    def count(self) -> int:
        return int(self.value(self.marker()))

    def value(self, m: bytes):
        if m in _FIXED:
            fmt, k = _FIXED[m]
            return struct.unpack(fmt, self.take(k))[0]
        if m == b"Z":
            return None
        if m == b"T":
            return True
        if m == b"F":
            return False
        if m == b"C":
            return self.take(1).decode()
        if m in (b"S", b"H"):
            s = self.take(self.count()).decode()
            return float(s) if m == b"H" else s
        if m in (b"[", b"{"):
            return self.container(m == b"{")
        raise ValueError(f"UBJSON marker {m!r}")

    def container(self, is_obj: bool):
        typ = n = None
        m = self.marker()
        if m == b"$":
            typ = self.take(1)
            m = self.marker()
        if m == b"#":
            n, m = self.count(), None
        if not is_obj and typ in _NP and n is not None:
            k = struct.calcsize(_FIXED[typ][0])
            return np.frombuffer(self.take(k * n), _NP[typ]).astype(
                np.float64 if typ in (b"d", b"D") else np.int64)
        out = {} if is_obj else []
        end = b"}" if is_obj else b"]"
        i = 0
        while n is None or i < n:
            if n is None:
                m = self.marker() if m is None else m
                if m == end:
                    break
            if is_obj:
                key_m = self.marker() if m is None else m
                key = self.take(int(self.value(key_m))).decode()
                out[key] = self.value(typ or self.marker())
            else:
                out.append(self.value(typ or (self.marker() if m is None
                                              else m)))
            m = None
            i += 1
        return out


def ubjson_decode(data: bytes):
    r = _Ubj(data)
    return r.value(r.marker())
