"""The port's checkpoint I/O (al26_tpu_torch.io) against the JAX package's
(al26_tpu.io): the same bytes and files, each package reading the other's
files (in subprocesses with the other package import-blocked), stored zstd
frames without the `zstandard` package, the yields store's framed file,
and the background writer. Inputs come from numpy seeds; everything runs
on the CPU.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from al26_tpu_torch.io import async_writer, checkpoint, compat, compression
from al26_tpu_torch.io import ubjson
from al26_tpu_torch.io.yields_store import _SERIES, Yields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the objects whose UBJSON bytes must equal the JAX codec's
_UBJSON_CASES = {
    "scalars": [None, True, False, 0, -1, 127, 128, 255, 256, -129, 2**31,
                -2**40, 2**70, 1.5, -0.0, float("inf"), "", "al26 ✓"],
    "containers": {"a": [1, [2, {"b": None}]], "c": {}, "d": [],
                   "e": (1.0, 2.0), "f": b"\x00\xffbytes"},
    "float_list": [0.1 * k for k in range(300)],
    "mixed_list": [1.0, 2, "x", 3.5],
    "np_float": np.random.default_rng(0).normal(size=(4, 5)),
    "np_int": np.arange(-50, 50, dtype=np.int64),
    "np_small": {"i8": np.arange(5, dtype=np.int8),
                 "u16": np.arange(5, dtype=np.uint16),
                 "u32": np.array([0, 2**32 - 1], dtype=np.uint32),
                 "u64": np.array([1, 2**63 + 5], dtype=np.uint64),
                 "f32": np.float32(0.25), "b": np.bool_(True)},
    "yields_like": {"time": [0.0, 0.1], "local_26al": [
        list(np.random.default_rng(1).uniform(size=50)),
        np.random.default_rng(2).uniform(size=50)], "first_write": False},
}


@pytest.mark.parametrize("case", sorted(_UBJSON_CASES))
def test_ubjson_bytes_equal_jax(case):
    """The port's codec writes the JAX codec's bytes (its pure-Python
    path, the behavioural specification) and reads them back alike."""
    from al26_tpu.io import ubjson as jub

    obj = _UBJSON_CASES[case]
    ours = ubjson.dumpb(obj)
    assert ours == jub.dumpb_python(obj)
    assert ubjson.loadb(ours) == jub.loadb_python(ours)
    assert ubjson.dumpb(obj, optimized=False) == jub.dumpb_python(
        obj, optimized=False)


@pytest.mark.parametrize("size", [0, 1, 131071, 131072, 131073, 300000])
def test_stored_frames_decode_everywhere(size):
    """A stored frame (Raw blocks of <= 128 KiB, content size in the
    header) decodes through zstandard, through the port's reader and
    through the JAX package's decompress."""
    import zstandard

    from al26_tpu.io.compression import decompress as jax_decompress

    data = np.random.default_rng(size).bytes(size)
    frame = compression.stored_frame(data)
    blocks = max(1, -(-size // (128 * 1024)))
    assert len(frame) == 4 + 2 + 8 + 3 * blocks + size
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert compression.decompress(frame) == data
    assert jax_decompress(frame) == data


def test_decompress_reads_compressed_rle_and_concatenated_frames():
    """Compressed frames go through zstandard; RLE blocks, skippable frames
    and concatenated frames decode in the port's reader."""
    import zstandard

    data = b"compressible " * 5000 + os.urandom(300)
    assert compression.decompress(
        zstandard.ZstdCompressor(level=8).compress(data)) == data
    # one frame of an RLE block (7 x b"z") and a Raw block, no content size
    rle = ((1 << 1) | (7 << 3)).to_bytes(3, "little") + b"z"
    raw = (1 | (3 << 3)).to_bytes(3, "little") + b"end"
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 7 << 3])
    skip = (0x184D2A51).to_bytes(4, "little") + (3).to_bytes(4, "little")
    stream = skip + b"xyz" + frame + rle + raw + compression.stored_frame(
        b"tail")
    assert compression.decompress(stream) == b"zzzzzzzend" + b"tail"
    with pytest.raises(ValueError):
        compression.decompress(b"not zstd")


def test_without_zstandard_writes_stored_frames(monkeypatch, tmp_path):
    """With no zstandard: compress and compress_stream write stored frames
    that the JAX reader (with zstandard) decodes, writer() says so, and a
    compressed frame raises ImportError naming the package."""
    import io

    import zstandard

    from al26_tpu.io.compression import decompress as jax_decompress

    packed = zstandard.ZstdCompressor().compress(b"abc" * 100)
    monkeypatch.setattr(compression, "_zstandard", lambda: None)
    assert "stored" in compression.writer()
    data = os.urandom(200000)
    frame = compression.compress(data)
    assert frame == compression.stored_frame(data)
    assert jax_decompress(frame) == data
    out = io.BytesIO()
    compression.compress_stream(io.BytesIO(data), out, len(data))
    assert out.getvalue() == frame
    with pytest.raises(ImportError, match="zstandard"):
        compression.decompress(packed)


def _feed(stores, k, n_star=6):
    """One synthetic snapshot (deterministic in k) into every store."""
    rng = np.random.default_rng(1000 + k)

    class _Q:
        def __init__(self, v):
            self.v = v

        def value_in(self, unit):
            return self.v

    class P:
        pass

    p = P()
    for iso in ("26al", "60fe"):
        for ch in ("local", "global", "sne", "agb", "agb_raw"):
            setattr(p, f"mass_{iso}_{ch}", _Q(rng.uniform(size=n_star)))
            if ch != "agb_raw":
                setattr(p, f"mass_{iso}_{ch}_final",
                        _Q(rng.uniform(size=n_star)))
    for s in stores:
        s.update_state(0.1 * k, p)


def _frames(path):
    """The decompressed UBJSON payload of every frame of a framed file."""
    out = []
    with open(path, "rb") as f:
        assert f.read(8) == b"AL26YF01"
        while True:
            head = f.read(12)
            if not head:
                return out
            out.append(compression.decompress(
                f.read(int.from_bytes(head[4:], "little"))))


@pytest.mark.parametrize("bounded", [False, True])
def test_yields_store_writes_jax_files(tmp_path, bounded):
    """The same snapshots through the port's store and the JAX package's:
    the CSV byte for byte, every frame's payload byte for byte, the blob
    decoding to the same object (bounded: streamed from the frames)."""
    from al26_tpu.io import ubjson as jub
    from al26_tpu.io.compression import decompress as jdec
    from al26_tpu.io.yields_store import Yields as JYields

    ours = Yields(str(tmp_path / "port"), bounded=bounded)
    jax = JYields(str(tmp_path / "jax"), bounded=bounded)
    for k in range(4):
        _feed([ours, jax], k)
        ours.marinate_frame(str(tmp_path / "port.ubjf"))
        jax.marinate_frame(str(tmp_path / "jax.ubjf"))
    for name in ("port", "jax"):
        store = ours if name == "port" else jax
        store.marinate(str(tmp_path / f"{name}.ubj.zst"),
                       frames_path=str(tmp_path / f"{name}.ubjf"))
    csv = [open(tmp_path / f"{n}-cluster-yields.csv").read()
           for n in ("port", "jax")]
    assert csv[0] == csv[1] and csv[0].count("\n") == 5
    assert _frames(tmp_path / "port.ubjf") == _frames(tmp_path / "jax.ubjf")
    blobs = []
    for name in ("port", "jax"):
        with open(tmp_path / f"{name}.ubj.zst", "rb") as f:
            d = jub.loadb_python(jdec(f.read()))
        d.pop("filename")
        blobs.append(d)
    assert blobs[0] == blobs[1]
    # the JAX store reads the port's blob and frames
    back = JYields("")
    back.plate_frames(str(tmp_path / "port.ubjf"))
    assert back.time == pytest.approx([0.0, 0.1, 0.2, 0.3])


def test_bounded_blob_without_zstandard_matches(monkeypatch, tmp_path):
    """The bounded store's streamed blob in stored frames (no zstandard)
    decodes to the in-memory store's blob."""
    monkeypatch.setattr(compression, "_zstandard", lambda: None)
    yb = Yields(str(tmp_path / "b"), bounded=True)
    yu = Yields(str(tmp_path / "u"))
    frames = str(tmp_path / "b.ubjf")
    for k in range(3):
        _feed([yb, yu], k)
        yb.marinate_frame(frames)
    for name in _SERIES:
        assert len(getattr(yb, name)) == 1 and len(getattr(yu, name)) == 3
    yb.marinate(str(tmp_path / "b.ubj.zst"), frames_path=frames)
    yu.marinate(str(tmp_path / "u.ubj.zst"))
    got = []
    for name in ("b", "u"):
        with open(tmp_path / f"{name}.ubj.zst", "rb") as f:
            raw = f.read()
        assert raw[:6] == compression.stored_frame(b"")[:6]
        d = ubjson.loadb(compression.decompress(raw))
        d.pop("filename")
        got.append(d)
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        yb.marinate(str(tmp_path / "b.ubj.zst"))


def test_frames_torn_tail_truncate_and_backfill(tmp_path):
    """The framed store's recovery, as tests/test_io.py holds the JAX one
    to: a torn tail is dropped on read and truncated on resume, frames
    after a resume time go, a blob-only history backfills."""
    base = str(tmp_path / "t")
    frames = base + "-yields.ubjf"
    y = Yields(base, bounded=True)
    for k in range(4):
        _feed([y], k)
        y.marinate_frame(frames)
    with open(frames, "ab") as f:
        f.write(b"FRME" + (10**6).to_bytes(8, "little") + b"torn!")
    loaded = Yields(base)
    loaded.plate_frames(frames)
    assert loaded.time == pytest.approx([0.0, 0.1, 0.2, 0.3])
    loaded.truncate_frames(frames, 0.21)
    probe = Yields(base)
    probe.plate_frames(frames)
    assert probe.time == pytest.approx([0.0, 0.1, 0.2])
    assert probe.local_26al_final == loaded.local_26al_final
    loaded.bound()
    _feed([loaded], 3)
    loaded.marinate_frame(frames)
    again = Yields(base)
    again.plate_frames(frames)
    assert again.time == pytest.approx([0.0, 0.1, 0.2, 0.3])
    hist = Yields(base)
    for k in range(3):
        _feed([hist], k)
    hist.backfill_frames(frames)
    back = Yields(base)
    back.plate_frames(frames)
    assert back.time == hist.time and back.local_26al == hist.local_26al


def test_truncate_csv_keeps_f32_boundary_row(tmp_path):
    y = Yields(str(tmp_path / "f32b"))
    path = f"{y.filename}-cluster-yields.csv"
    t_ckpt = float(np.float32(9.995))
    with open(path, "w") as f:
        f.write("time,local_26al,global_26al,sne_26al,"
                "local_60fe,global_60fe,sne_60fe\n")
        f.write("{:.6e},0,0,0,0,0,0\n".format(t_ckpt))
        f.write("{:.6e},0,0,0,0,0,0\n".format(t_ckpt + 0.01))
    y.truncate_csv(t_ckpt)
    assert len(open(path).read().strip().splitlines()) == 2


def _columns(n=20, seed=3):
    """A reference-layout column set of n stars from a numpy seed."""
    from al26_tpu_torch.state import N_CH, N_ISO

    rng = np.random.default_rng(seed)
    d = {"pos": rng.normal(size=(n, 3)), "vel": rng.normal(size=(n, 3)),
         "mass": rng.uniform(0.1, 20, n), "m0": rng.uniform(0.1, 20, n),
         "mdot": rng.uniform(0, 1e-3, n), "kicked": rng.uniform(size=n) < .2,
         "r_disk": np.full(n, 4.8e-4), "tau_disk": rng.uniform(0, 5, n),
         "disk_alive": rng.uniform(size=n) < .5,
         "m_disk_gas": rng.uniform(size=n), "m_disk_dust": rng.uniform(size=n),
         "mass_27al": rng.uniform(size=n), "mass_56fe": rng.uniform(size=n),
         "slr": rng.uniform(size=(n, N_ISO, N_CH)),
         "slr_final": rng.uniform(size=(n, N_ISO, N_CH)),
         "agb_raw": rng.uniform(size=(n, N_ISO)),
         "wind_ratio": rng.uniform(size=(n, N_ISO)),
         "sn_yield": rng.uniform(size=(n, N_ISO)),
         "total_wind_loss": rng.uniform(size=n),
         "is_interloper": np.zeros(n, bool)}
    return d


def _save(pkg, base, cols):
    """One checkpoint (#3, t = 0.75 Myr) through a package's own classes."""
    mod = __import__(f"{pkg}.io.compat", fromlist=["x"])
    ck = __import__(f"{pkg}.io.checkpoint", fromlist=["x"])
    ys = __import__(f"{pkg}.io.yields_store", fromlist=["x"])
    args = mod.Args(n=len(cols["mass"]), rc=0.5, final_time=1.0,
                    filename=os.path.basename(base))
    md = mod.Metadata(args, 1.0, filename=os.path.basename(base))
    md.update(0.75)
    md.most_recent_checkpoint = 3
    particles = mod.cluster_to_particles(cols)
    y = ys.Yields(base)
    y.update_state(0.75, particles)
    ck.save_checkpoint(base, 3, particles, mod.Converter(0.5, 12.5), y, md)
    return particles


_BLOCK = """
import importlib.abc, json, sys
import numpy as np
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _subprocess(code, blocked, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _BLOCK.format(blocked=blocked) + code],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_loads_jax_checkpoint_without_jax(tmp_path):
    """A state file the JAX package wrote loads in the port with jax and
    al26_tpu import-blocked: the port's classes, the same columns."""
    cols = _columns()
    _save("al26_tpu", str(tmp_path / "j"), cols)
    np.savez(tmp_path / "want.npz", x=cols["pos"][:, 0], m=cols["mass"],
             s=cols["slr"][:, 0, 1])
    code = """
from al26_tpu_torch.io import checkpoint, compat
st = checkpoint.load_state("j-state-00003.pkl.zst")
want = np.load("want.npz")
from al26_tpu_torch.units import Quantity, msol, myr, pc
print(json.dumps({
    "types": [type(st).__module__, type(st.cluster).__module__,
              type(st.metadata.time).__module__],
    "x": bool(np.array_equal(st.cluster.x.value_in(pc), want["x"])),
    "m": bool(np.array_equal(st.cluster.mass.value_in(msol), want["m"])),
    "s": bool(np.array_equal(st.cluster.mass_26al_global.value_in(msol),
                             want["s"])),
    "t": st.metadata.time.value_in(myr), "n": st.metadata.args.n,
    "conv": type(st.converter).__name__,
    "jax_loaded": any(k.split(".")[0] in ("jax", "al26_tpu")
                      for k in sys.modules)}))
"""
    got = _subprocess(code, ["jax", "al26_tpu"], tmp_path)
    assert got["types"] == ["al26_tpu_torch.io.compat"] * 2 + [
        "al26_tpu_torch.units"]
    assert got["x"] and got["m"] and got["s"]
    assert got["t"] == 0.75 and got["n"] == 20 and got["conv"] == "Converter"
    assert not got["jax_loaded"]


def test_jax_loads_port_checkpoint_without_torch(tmp_path):
    """A state file the port wrote names the JAX package's classes and
    loads through al26_tpu.io.checkpoint.load_state with torch and
    al26_tpu_torch import-blocked."""
    cols = _columns(seed=5)
    _save("al26_tpu_torch", str(tmp_path / "p"), cols)
    with open(tmp_path / "p-state-00003.pkl.zst", "rb") as f:
        payload = compression.decompress(f.read())
    assert b"al26_tpu.io.compat" in payload and b"al26_tpu.units" in payload
    assert b"al26_tpu_torch" not in payload
    np.savez(tmp_path / "want.npz", v=cols["vel"][:, 2], t=cols["tau_disk"])
    code = """
from al26_tpu.io.checkpoint import load_checkpoint, load_state
from al26_tpu.units import myr, pcmyr
st = load_state("p-state-00003.pkl.zst")
_, _, y, _ = load_checkpoint("p", 3)
want = np.load("want.npz")
print(json.dumps({
    "types": [type(st).__module__, type(st.cluster).__module__,
              type(st.metadata.time).__module__],
    "v": bool(np.array_equal(st.cluster.vz.value_in(pcmyr), want["v"])),
    "tau": bool(np.array_equal(st.cluster.tau_disk.value_in(myr),
                               want["t"])),
    "t": st.metadata.time.value_in(myr), "yields_t": y.time,
    "torch_loaded": any(k.split(".")[0] in ("torch", "al26_tpu_torch")
                        for k in sys.modules)}))
"""
    got = _subprocess(code, ["torch", "al26_tpu_torch"], tmp_path)
    assert got["types"] == ["al26_tpu.io.compat"] * 2 + ["al26_tpu.units"]
    assert got["v"] and got["tau"] and got["t"] == 0.75
    assert got["yields_t"] == [0.75]
    assert not got["torch_loaded"]


def test_checkpoint_roundtrip_and_amuse_fixture(tmp_path):
    """The port reads its own files, and a reference-like AMUSE pickle
    (tests/amuse_fixture.py) through the tolerant loader: the columns in
    canonical units, the metadata quantities re-tagged."""
    from amuse_fixture import build_state_pickle

    from al26_tpu_torch.units import msol, myr, pc

    cols = _columns(seed=7)
    particles = _save("al26_tpu_torch", str(tmp_path / "r"), cols)
    st = checkpoint.load_state(str(tmp_path / "r-state-00003.pkl.zst"))
    for k, v in particles.columns().items():
        np.testing.assert_array_equal(st.cluster.columns()[k], v)
    assert checkpoint.most_recent_checkpoint(str(tmp_path / "r")) == 3
    ref_cols = compat.cluster_to_particles(cols).columns()
    blob = build_state_pickle(ref_cols, 20, 1.0, 3.0, 10.0, "pt-0")
    st = compat.loads(blob)
    assert isinstance(st.cluster, compat.Particles)
    np.testing.assert_allclose(st.cluster.x.value_in(pc), cols["pos"][:, 0],
                               rtol=1e-12)
    np.testing.assert_allclose(st.cluster.mass.value_in(msol), cols["mass"],
                               rtol=1e-12)
    assert st.metadata.time.value_in(myr) == pytest.approx(3.0)
    assert st.metadata.args.n == 20
    back = compat.particles_to_cluster(st.cluster, device="cpu")
    np.testing.assert_allclose(back.vel.numpy(), cols["vel"], rtol=1e-12)


def test_writer_orders_jobs_and_reraises():
    """io.async_writer, as tests/test_async_writer.py holds the JAX one:
    FIFO order, an error re-raised on the driver thread, later jobs of a
    failed epoch skipped, a fresh epoch usable."""
    seen = []
    w = async_writer.AsyncCheckpointWriter()
    for k in range(5):
        w.submit(lambda k=k: (time.sleep(0.002), seen.append(k)))
    w.flush()
    assert seen == list(range(5))
    gate = threading.Event()

    def boom():
        gate.wait(5)
        raise OSError("disk full")

    w.submit(boom)
    w.submit(lambda: seen.append("skipped"))
    gate.set()
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        w.flush()
    w.submit(lambda: seen.append("after"))
    w.close()
    assert seen == list(range(5)) + ["after"]
