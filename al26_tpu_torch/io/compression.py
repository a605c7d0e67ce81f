"""zstd compression of the checkpoint files (al26_nbody.py:320-345), with
or without the `zstandard` package.

Where `zstandard` imports, `compress` writes level-8 frames on all
threads, as the JAX package does (al26_tpu/io/compression.py). Where it
does not, `compress` writes STORED zstd frames: the content as Raw_Block
blocks of at most 128 KiB (RFC 8878 §3.1.1.2), with the content size in
the frame header. Every zstd decoder reads them, the JAX package's and the
reference's one-shot `ZstdDecompressor().decompress` included; the file is
the size of its content (plus 3 bytes a block). `writer()` says which of
the two this process writes.

`decompress` decodes frames of Raw and RLE blocks itself and hands a
frame with compressed blocks to `zstandard`; without it, such a frame
raises ImportError naming the package.
"""
from __future__ import annotations

import io
import struct

_MAGIC = 0xFD2FB528
_SKIPPABLE = range(0x184D2A50, 0x184D2A60)   # skippable-frame magics
_BLOCK_MAX = 128 * 1024                      # Block_Maximum_Size at a
#                                              128 KiB window
_RAW, _RLE = 0, 1


def _zstandard():
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def writer() -> str:
    """What `compress` writes in this process."""
    if _zstandard() is not None:
        return "zstandard, level 8"
    return "stored zstd frames (Raw blocks; the zstandard package is absent)"


def _frame_header(size: int) -> bytes:
    """Magic, Frame_Header_Descriptor (8-byte content size, a window
    descriptor, no checksum, no dictionary), Window_Descriptor 2^17
    (128 KiB: exponent 7, mantissa 0), Frame_Content_Size."""
    return struct.pack("<IBBQ", _MAGIC, 0xC0, 7 << 3, size)


def _block_header(size: int, last: bool) -> bytes:
    """Last_Block (bit 0), Block_Type Raw (bits 1-2), Block_Size (3-23)."""
    return (int(last) | (_RAW << 1) | (size << 3)).to_bytes(3, "little")


def _stored_pieces(read, size: int):
    """One stored zstd frame of `size` bytes taken from `read(k)` (the
    next k bytes), piece by piece: the frame header, then each Raw block's
    header and content (one empty last block for empty content)."""
    yield _frame_header(size)
    if size == 0:
        yield _block_header(0, True)
    left = size
    while left > 0:
        chunk = read(min(_BLOCK_MAX, left))
        if not chunk:
            raise IOError(f"input ended {left} bytes short of {size}")
        left -= len(chunk)
        yield _block_header(len(chunk), left == 0)
        yield chunk


def stored_frame(data: bytes) -> bytes:
    """`data` as one stored zstd frame."""
    buf = io.BytesIO(data)
    return b"".join(_stored_pieces(buf.read, buf.getbuffer().nbytes))


def compress(data: bytes, level: int = 8, threads: int = -1) -> bytes:
    zstd = _zstandard()
    if zstd is None:
        return stored_frame(data)
    return zstd.ZstdCompressor(threads=threads, level=level).compress(data)


def compress_stream(ifh, ofh, size: int, level: int = 8) -> None:
    """Compress `size` bytes from file `ifh` into `ofh`, the content size
    recorded in the frame header (the reference's one-shot decompress
    needs it)."""
    zstd = _zstandard()
    if zstd is not None:
        zstd.ZstdCompressor(level=level, threads=-1).copy_stream(
            ifh, ofh, size=size)
        return
    for piece in _stored_pieces(ifh.read, size):
        ofh.write(piece)


def _with_zstandard(data: bytes) -> bytes:
    zstd = _zstandard()
    if zstd is None:
        raise ImportError(
            "this file holds compressed zstd blocks: reading it needs the "
            "zstandard package (files written without it hold stored "
            "blocks, which decode without it)")
    return zstd.ZstdDecompressor().decompress(data)


def decompress(data: bytes) -> bytes:
    """Decode every frame of `data`: Raw and RLE blocks here, a frame
    with compressed blocks through `zstandard`."""
    buf = memoryview(data).cast("B")
    out = bytearray()
    pos, n = 0, len(buf)
    while pos < n:
        if pos + 4 > n:
            raise ValueError("truncated zstd frame magic")
        magic = struct.unpack_from("<I", buf, pos)[0]
        if magic in _SKIPPABLE:
            pos += 8 + struct.unpack_from("<I", buf, pos + 4)[0]
            continue
        if magic != _MAGIC:
            raise ValueError(f"not a zstd frame (magic {magic:#x})")
        fhd = buf[pos + 4]
        fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
        checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
        pos += 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_flag]
        pos += (1 if single else 0, 2, 4, 8)[fcs_flag]
        while True:
            if pos + 3 > n:
                raise ValueError("truncated zstd block header")
            head = int.from_bytes(buf[pos:pos + 3], "little")
            last, kind, size = head & 1, (head >> 1) & 3, head >> 3
            pos += 3
            if kind == _RAW:
                if pos + size > n:
                    raise ValueError("truncated zstd Raw block")
                out += buf[pos:pos + size]
                pos += size
            elif kind == _RLE:
                out += bytes(buf[pos:pos + 1]) * size
                pos += 1
            else:
                return _with_zstandard(bytes(data))
            if last:
                break
        pos += 4 if checksum else 0
    return bytes(out)
