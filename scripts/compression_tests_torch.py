"""Serialisation + compression timing harness on al26_tpu_torch (the
port's counterpart of benchmarks/compression_tests.py, after the
reference's bench/compression/compression-tests.py, results tabulated in
its filetypes.md).

    python scripts/compression_tests_torch.py [yields.ubj.zst]

Builds the JAX script's synthetic yields payload (six series of 1000
checkpoints x 1000 stars uniforms from np.random.default_rng(0), and the
time column), or takes a real yields file. Times the port's UBJSON codecs
on it, native and Python (encode and decode seconds; the two write the
same bytes and read the same object), then every compressor present: the
port's checkpoint writer (io.compression, stored zstd frames where
`zstandard` is absent), `zstandard` at levels 3, 8 and 19 where it is
installed, zlib, gzip, bz2 and lzma. Everything here runs on the host, so
the script has no --device.
"""
from __future__ import annotations

import argparse
import bz2
import gzip
import lzma
import os
import statistics
import sys
import time
import zlib

import numpy as np

# `python scripts/compression_tests_torch.py` puts scripts/ (not the repo
# root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_series(n_stars: int = 1000, n_checkpoints: int = 1000) -> dict:
    """The JAX script's payload (benchmarks/compression_tests.py:
    build_payload), before encoding."""
    rng = np.random.default_rng(0)
    series = {
        f"{ch}_{iso}": [rng.uniform(size=n_stars).tolist()
                        for _ in range(n_checkpoints)]
        for iso in ("26al", "60fe") for ch in ("local", "global", "sne")
    }
    series["time"] = np.linspace(0, 10, n_checkpoints).tolist()
    return series


def codec_times(obj, reps: int = 1) -> tuple[bytes, dict]:
    """The payload's bytes and {codec: (encode s, decode s)}, each the
    median of `reps` calls, for the port's native and Python codecs;
    raises if the native codec is not in use, if a codec does not read
    back its payload, or if the two write other bytes."""
    from al26_tpu_torch.io import ubjson

    native_dumpb, native_loadb = ubjson.native_codec()
    out, data = {}, {}
    for name, enc, dec in (("native", native_dumpb, native_loadb),
                           ("python", ubjson.dumpb_python,
                            ubjson.loadb_python)):
        te, td = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            data[name] = enc(obj)
            t1 = time.perf_counter()
            back = dec(data[name])
            td.append(time.perf_counter() - t1)
            te.append(t1 - t0)
            if back != obj:
                raise RuntimeError(f"the {name} codec does not read back "
                                   "its payload")
        out[name] = (statistics.median(te), statistics.median(td))
    if data["native"] != data["python"]:
        raise RuntimeError("the native and Python codecs write other bytes")
    return data["native"], out


def compressors() -> list:
    """(name, compress) of every compressor present."""
    from al26_tpu_torch.io import compression

    out = [(f"port ({compression.writer()})", compression.compress)]
    try:
        import zstandard as zstd
    except ImportError:
        zstd = None
    if zstd is not None:
        out += [(f"zstd-{lv}", lambda d, lv=lv: zstd.ZstdCompressor(
            level=lv, threads=-1).compress(d)) for lv in (3, 8, 19)]
    out += [("zlib-6", lambda d: zlib.compress(d, 6)),
            ("gzip-6", lambda d: gzip.compress(d, 6)),
            ("bz2-9", lambda d: bz2.compress(d, 9)),
            ("lzma-6", lambda d: lzma.compress(d, preset=6))]
    return out


def main(yields_file: str | None = None, n_stars: int = 1000,
         n_checkpoints: int = 1000) -> dict:
    from al26_tpu_torch.io import compression, ubjson

    if yields_file:
        with open(yields_file, "rb") as f:
            obj = ubjson.loadb(compression.decompress(f.read()))
    else:
        obj = build_series(n_stars, n_checkpoints)
    raw, codecs = codec_times(obj)
    print(f"{'codec':>8} {'encode (s)':>11} {'decode (s)':>11} "
          f"{'MiB':>8}")
    for name, (enc, dec) in codecs.items():
        print(f"{name:>8} {enc:11.4f} {dec:11.4f} {len(raw) / 2**20:8.2f}")
    print(f"{'compressor':>40} {'time (s)':>9} {'MiB':>8} {'ratio':>7} "
          f"{'MiB/s':>8}")
    size0 = len(raw) / 2**20
    packed = {}
    for name, fn in compressors():
        t0 = time.perf_counter()
        out = fn(raw)
        dt = time.perf_counter() - t0
        packed[name] = len(out)
        print(f"{name:>40} {dt:9.3f} {len(out) / 2**20:8.2f} "
              f"{len(raw) / len(out):7.2f} {size0 / dt:8.1f}")
    return {"payload": raw, "codecs": codecs, "packed_bytes": packed}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("yields_file", nargs="?", default=None)
    main(ap.parse_args().yields_file)
