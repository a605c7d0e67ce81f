"""The port's native UBJSON codec (al26_tpu_torch/io/native/, built at
first use by io.native_build) against the Python codec it is held to and
against the JAX package's two codecs: the same objects give the same
bytes through all four, malformed input raises instead of crashing, the
build is named by hash, loaded by path under its own module name and safe
to race, and yields files written through it load in the JAX package's
`Yields` (and the reverse).

The tests skip only where no C++ compiler is found; a build that fails
fails them.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from al26_tpu_torch.io import compression, native_build, ubjson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

natives = pytest.mark.skipif(native_build.compiler() is None,
                             reason="no C++ compiler (c++ or g++)")

_OBJS = {
    "none": None, "true": True, "false": False, "zero": 0, "minus": -1,
    "u8": 255, "i16": -129, "i64": 2**40, "i64_neg": -2**40,
    "float": 1.5, "tiny": -2.5e-30, "str": "hello", "utf8": "ünïcødé",
    "nested": {"a": [1.0, 2.0, 3.0], "b": {"c": [1, "x"]}},
    "ragged": [[1.0, 2.0], [3.0]], "empty_list": [], "empty_dict": {},
    "int_list": list(range(300)), "float_list": [1.0] * 1000,
    "bytes": b"\x00\xffbytes", "tuple": (1.0, 2.0),
    "big_int": 2**100, "big_int_neg": -2**100,
}


@pytest.fixture(scope="module")
def jub():
    from al26_tpu.io import ubjson as jub

    return jub


@natives
@pytest.mark.parametrize("case", sorted(_OBJS))
def test_native_matches_python_and_jax_wire(case, jub):
    """The port's native codec, the port's and the JAX package's Python
    codecs and the JAX package's native codec write the same bytes, and
    each decoder reads them back to the object."""
    obj = _OBJS[case]
    assert ubjson.codec() == "native"
    nat = ubjson._native.dumpb(obj)
    assert nat == ubjson.dumpb(obj) == ubjson.dumpb_python(obj)
    assert nat == jub.dumpb_python(obj)
    assert jub._native is not None, "the JAX package's codec is not built"
    assert nat == jub._native.dumpb(obj)
    want = list(obj) if isinstance(obj, tuple) else obj
    assert ubjson._native.loadb(nat) == ubjson.loadb_python(nat) == want
    assert jub.loadb_python(nat) == want


@natives
@pytest.mark.parametrize("optimized", [False, True])
def test_native_reads_python_only_forms(optimized):
    """The unoptimized wire form (the Python encoder's only) and numpy
    payloads (the Python encoder, after the native one's TypeError)
    decode alike."""
    obj = {"t": [0.5, 1, "s", None], "u": [True, False], "f": [0.25, 0.5]}
    plain = ubjson.dumpb_python(obj, optimized=optimized)
    assert ubjson._native.loadb(plain) == obj
    arr = {"a": np.arange(6.0).reshape(2, 3), "i": np.arange(4)}
    data = ubjson.dumpb(arr, optimized=optimized)
    assert data == ubjson.dumpb_python(arr, optimized=optimized)
    assert ubjson.loadb(data) == ubjson.loadb_python(data)


@natives
@pytest.mark.parametrize("v", [2**63, 2**100, -2**100, 10**40 + 7])
def test_native_big_int_roundtrip(v):
    data = ubjson._native.dumpb(v)
    assert data[:1] == b"H" and data == ubjson.dumpb_python(v)
    assert ubjson._native.loadb(data) == ubjson.loadb_python(data) == v


@natives
def test_native_speed():
    payload = {"series": [list(np.random.default_rng(0).uniform(size=1000))
                          for _ in range(1000)]}
    t0 = time.perf_counter()
    data = ubjson._native.dumpb(payload)
    enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ubjson._native.loadb(data)
    dec = time.perf_counter() - t0
    assert back == payload
    # the reference quotes ~0.2 s for this payload via py-ubjson (the JAX
    # package's tests/test_io.py holds its codec to the same bar)
    assert enc < 3.0 and dec < 3.0, (enc, dec)


def _deep(depth):
    deep = v = []
    for _ in range(depth):
        inner = []
        v.append(inner)
        v = inner
    return deep


_BAD = {
    "lone_surrogate": ("dumpb", "\ud800",
                       (UnicodeEncodeError, TypeError, ValueError)),
    "lone_surrogate_key": ("dumpb", {"\ud800": 1},
                           (UnicodeEncodeError, TypeError, ValueError)),
    "deep_encode": ("dumpb", _deep(10_000), RecursionError),
    "deep_decode": ("loadb", b"[" * 1_000_000, ValueError),
    "truncated": ("loadb", b"[D\x00\x00", ValueError),
    "truncated_typed": ("loadb", b"[$D#i\x04" + b"\x00" * 9, ValueError),
    "bad_marker": ("loadb", b"Q", ValueError),
}


@natives
@pytest.mark.parametrize("case", sorted(_BAD))
def test_native_codec_robustness(case):
    """Malformed input raises a catchable exception instead of crashing
    the interpreter."""
    fn, arg, exc = _BAD[case]
    with pytest.raises(exc):
        getattr(ubjson._native, fn)(arg)


@natives
def test_native_is_the_port_build_loaded_by_path(jub):
    """The module is the port's own build: under al26_tpu_torch/_build/,
    named after the source's hash, under its own module name, not the
    JAX package's module nor under its name."""
    assert ubjson.codec() == "native"
    path = os.path.realpath(ubjson._native.__file__)
    build = os.path.realpath(os.path.join(REPO, "al26_tpu_torch", "_build"))
    assert os.path.dirname(path) == build
    assert path == os.path.realpath(native_build.library_path())
    assert os.path.basename(path).startswith("_ubjson_native_torch_")
    assert ubjson._native.__name__ == "_ubjson_native_torch"
    assert ubjson._native is not jub._native
    assert sys.modules.get("_ubjson_native") is not ubjson._native


def test_codec_without_compiler_is_python(monkeypatch):
    """No C++ compiler: the Python codec, and codec() says why."""
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    monkeypatch.setattr(ubjson, "_native", None)
    monkeypatch.setattr(ubjson, "_codec", None)
    assert ubjson.codec().startswith("python (no C++ compiler")
    obj = _OBJS["nested"]
    assert ubjson.dumpb(obj) == ubjson.dumpb_python(obj)
    assert ubjson.loadb(ubjson.dumpb(obj)) == obj
    assert ubjson._native is None


@natives
def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is present and fails raises; nothing falls back to
    the Python codec."""
    bad = tmp_path / "ubjson_native.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native_build, "SOURCE", str(bad))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(ubjson, "_native", None)
    monkeypatch.setattr(ubjson, "_codec", None)
    with pytest.raises(RuntimeError, match="failed"):
        ubjson.dumpb({"a": 1})
    with pytest.raises(RuntimeError, match="failed"):
        ubjson.codec()
    assert not os.path.exists(native_build.library_path())
    assert [f for f in os.listdir(native_build.BUILD_DIR) if ".tmp" in f] == []


@natives
def test_failed_build_leaves_no_partial_file(monkeypatch, tmp_path):
    """A compiler that writes part of its output and then fails raises,
    and its temporary file is removed: the build directory stays empty."""
    cc = tmp_path / "cc"
    cc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                  '  if [ "$1" = "-o" ]; then echo partial > "$2"; fi\n'
                  '  shift\ndone\nexit 1\n')
    cc.chmod(0o755)
    monkeypatch.setattr(native_build, "compiler", lambda: str(cc))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed"):
        native_build.build()
    assert os.listdir(native_build.BUILD_DIR) == []


@natives
def test_threads_at_first_use_load_the_codec_once(monkeypatch):
    """Threads that call the codec for the first time at once (the driver
    and its writer thread) load the module once and all get its bytes."""
    import threading

    loads = []
    real_load = native_build.load

    def counted_load():
        loads.append(1)
        return real_load()

    monkeypatch.setattr(native_build, "load", counted_load)
    monkeypatch.setattr(ubjson, "_native", None)
    monkeypatch.setattr(ubjson, "_codec", None)
    obj = _OBJS["nested"]
    want = ubjson.dumpb_python(obj)
    out = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: out.append(
            ubjson.dumpb(obj))) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert loads == [1] and out == [want] * 16
    assert ubjson.codec() == "native"


@natives
def test_concurrent_builds_load_one_whole_file(tmp_path):
    """Four processes build into an empty directory at once (the test
    workers and mesh ranks of a fresh checkout): every one loads a whole
    library, one library is left, no temporary file, and a stale file of
    another name is never taken for it."""
    build = tmp_path / "_build"
    build.mkdir()
    stale = build / ("_ubjson_native_23646a6c75ccc0f4"
                     + os.path.splitext(native_build.library_path())[1])
    stale.write_bytes(b"not a library")
    code = textwrap.dedent(f"""
        from al26_tpu_torch.io import native_build
        native_build.BUILD_DIR = {str(build)!r}
        mod = native_build.load()
        assert mod.loadb(mod.dumpb({{"x": [1.0, 2.0]}})) == {{"x": [1.0, 2.0]}}
        print(mod.__file__)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    files = {out.strip() for out, _ in outs}
    assert len(files) == 1
    left = sorted(os.listdir(build))
    assert left == sorted([stale.name, os.path.basename(files.pop())])


# ---------------------------------------------------------------------------
# yields files across the packages
# ---------------------------------------------------------------------------
KW = dict(n=40, rc=0.5, final_time=0.2, seed=9, n_plot=5, steps_per_plot=4,
          dtype="f64", filename="yc")


@pytest.fixture(scope="module")
def yields_runs(tmp_path_factory):
    """A short run of each driver (n = 40, 20 steps, 7 saves), each in
    its own directory."""
    import torch

    from al26_tpu.config import SimConfig as JConfig
    from al26_tpu.sim.driver import run as jrun
    from al26_tpu_torch import SimConfig as TConfig
    from al26_tpu_torch.sim import driver

    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("yields")
    old = os.getcwd()
    try:
        for name in ("port", "jax"):
            os.makedirs(root / name)
            os.chdir(root / name)
            if name == "port":
                driver.run(TConfig(**KW), progress=False, device="cpu")
            else:
                jrun(JConfig(**KW), progress=False)
    finally:
        os.chdir(old)
    return root


def _series(store) -> dict:
    return {k: v for k, v in vars(store).items()
            if isinstance(v, list) and not k.startswith("_")}


@natives
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_yields_files_load_across_packages(yields_runs, writer, jub):
    """The blob and the framed store one package's run writes load in the
    other package's `Yields` to the same series as in its own; the blob's
    payload encodes to the same bytes through all four codecs."""
    from al26_tpu.io.compression import decompress as jdec
    from al26_tpu.io.yields_store import Yields as JYields
    from al26_tpu_torch.io.yields_store import Yields as TYields

    assert ubjson.codec() == "native"
    base = str(yields_runs / writer / "yc-yields")
    loaded = {}
    for pkg, cls in (("port", TYields), ("jax", JYields)):
        blob, frames = cls(""), cls("")
        blob.plate(base + ".ubj.zst")
        frames.plate_frames(base + ".ubjf")
        assert _series(blob) == _series(frames)
        loaded[pkg] = _series(blob)
    assert loaded["port"] == loaded["jax"]
    assert len(loaded["port"]["time"]) == 7
    with open(base + ".ubj.zst", "rb") as f:
        raw = f.read()
    payload = ubjson.loadb(compression.decompress(raw))
    assert payload == jub.loadb_python(jdec(raw))
    data = ubjson.dumpb(payload)
    assert data == ubjson.dumpb_python(payload) == jub.dumpb_python(payload)
    assert data == jub._native.dumpb(payload)
