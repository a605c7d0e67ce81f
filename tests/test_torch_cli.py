"""The port's command line (al26_tpu_torch.cli) against the JAX package's
(al26_tpu.cli): every flag with the same dest, default and choices, the
same SimConfig from the same argv, the refusals of what is not ported,
and a run end to end on the CPU (cold, resumed, extended).
"""
import glob
import os
import re

import numpy as np
import pytest
import torch

from al26_tpu_torch import cli
from al26_tpu_torch.io.checkpoint import load_state
from al26_tpu_torch.io.compat import particles_to_cluster
from al26_tpu_torch.state import cluster_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _actions(parser):
    return {tuple(a.option_strings): a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_every_jax_flag_exists_with_the_same_meaning():
    from al26_tpu import cli as jcli

    jax, port = _actions(jcli.build_parser()), _actions(cli.build_parser())
    assert set(port) - set(jax) == {("--device",)}
    for opts, ja in jax.items():
        pa = port[opts]
        assert pa.dest == ja.dest, opts
        assert pa.default == ja.default, opts
        assert (tuple(pa.choices) if pa.choices else None) == (
            tuple(ja.choices) if ja.choices else None), opts
        assert type(pa) is type(ja), opts
        assert getattr(pa.type, "__name__", pa.type) == getattr(
            ja.type, "__name__", ja.type), opts
    dev = port[("--device",)]
    assert dev.default == "cuda" and dev.dest == "device"


@pytest.mark.parametrize("argv", [
    ["-n", "100", "-rc", "0.5"],
    ["-n", "64", "-rc", "1", "-t_f", "3", "--dtype", "f32", "--seed", "7",
     "-i", "-mi", "4.0", "-trji", "--integrator", "hermite4_block",
     "--force_impl", "tree", "--tree_mac", "relative", "--k_ultra", "16"],
    ["-r", "runs/sim", "-nc", "4", "-t_f", "20", "-v"],
    ["-n", "10", "-rc", "1", "--ensemble", "8", "--no_force_cache",
     "--yields_rewrite", "--sync_saves", "--sn_parity_mode",
     "--metallicity", "0.01", "--yields_vel", "0", "--device", "cpu"],
    ["-n", "32", "-rc", "1", "--integrator", "hermite4_block",
     "--force_impl", "pallas", "--gravity_stride", "4", "--softened_virial",
     "--device", "cpu"],
])
def test_same_config_as_jax(argv):
    """The same argv gives the same SimConfig in both packages (--device
    is the port's own and stays out of the config)."""
    from al26_tpu import cli as jcli

    jargv = [a for a in argv if a not in ("--device", "cpu")]
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jcli.config_from_args(jcli.build_parser().parse_args(jargv))
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("flags", [
    ["--mesh_shape", "2,2"], ["--force_impl", "sharded"],
    ["--force_impl", "ring"], ["--orbax_dir", "ob"],
])
def test_not_ported_flags_refused_before_any_run(flags, tmp_path,
                                                 monkeypatch):
    """The multi-device flags are ported. In a plain process a mesh of 4
    devices is refused with a ValueError naming torchrun, and the mesh
    backends without a mesh with the JAX package's ValueError, both before
    any file is written; --orbax_dir runs and writes the DCP tree at every
    save."""
    monkeypatch.chdir(tmp_path)
    argv = ["-n", "8", "-rc", "1", "-f", "x", "--device", "cpu"] + flags
    if flags[0] == "--orbax_dir":
        from al26_tpu_torch.io.orbax_backend import latest_step

        assert cli.main(argv + ["-t_f", "0.02"]) == 0
        # the 101 saves of the 1000 steps: after steps 1, 11, ..., 991
        # and the final one
        trees = [d for d in os.listdir("ob") if d.isdigit()]
        assert len(trees) == 101 and latest_step("ob") == 1000
        return
    match = ("torchrun --nproc_per_node 4" if flags[0] == "--mesh_shape"
             else "requires a device mesh")
    with pytest.raises(ValueError, match=match):
        cli.main(argv)
    assert os.listdir(tmp_path) == []


def test_mesh_of_one_runs_through_the_cli(tmp_path, monkeypatch):
    """--mesh_shape 1 in a plain process: a world of one, the mesh path,
    the same files and final state as the run without a mesh."""
    monkeypatch.chdir(tmp_path)
    base = ["-n", "16", "-rc", "1", "-t_f", "0.05", "--device", "cpu"]
    assert cli.main(base + ["-f", "m", "--mesh_shape", "1",
                            "--force_impl", "ring"]) == 0
    assert cli.main(base + ["-f", "p"]) == 0
    names = lambda p: sorted(f[1:] for f in os.listdir(".")
                             if f.startswith(p + "-"))
    assert names("m") == names("p") and len(names("m")) > 3
    a, b = (cluster_to_numpy(particles_to_cluster(
        load_state(f"{p}-state-00006.pkl.zst").cluster, device="cpu"))
        for p in ("m", "p"))
    for k in ("pos", "vel", "slr"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12,
                                   atol=1e-12 * np.abs(b[k]).max())


def test_gravity_stride_runs_on_cpu(tmp_path, monkeypatch):
    """--gravity_stride 4 on a stride-capable path (the kernel path's
    plain versions on the CPU, hermite4_block) runs the strides: every
    save of the 1000 steps is written, 200 strides ran (each save chunk
    of 9 steps is 2 strides and a plain step), and the clock lands on
    t_f."""
    import importlib

    # the module (sim/__init__ re-exports a function `step`)
    port_step = importlib.import_module("al26_tpu_torch.sim.step")
    strides = []
    real = port_step.run_strides_cached

    def counted(*args, **kwargs):
        strides.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_step, "run_strides_cached", counted)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-n", "16", "-rc", "0.5", "--seed", "3", "--dtype",
                     "f64", "-t_f", "0.005", "-f", "str", "--integrator",
                     "hermite4_block", "--force_impl", "pallas",
                     "--gravity_stride", "4", "--device", "cpu"]) == 0
    assert sum(strides) == 100 * 2
    states = sorted(glob.glob("str-state-*.pkl.zst"))
    assert len(states) == 102
    st = load_state(states[-1])
    assert st.metadata.args.gravity_stride == 4
    c = cluster_to_numpy(particles_to_cluster(st.cluster, device="cpu"))
    assert np.isfinite(c["pos"]).all()


def test_cli_runs_resumes_and_extends_on_cpu(tmp_path, monkeypatch,
                                             capsys):
    """-n 16, 1000 steps of 5e-6 Myr, 102 saves: the files; `-r -nc 50`
    reproduces the last state bit for bit; `-r -t_f` extends on the same
    step grid. Without --device, a machine with no card raises."""
    monkeypatch.chdir(tmp_path)
    base = ["-n", "16", "-rc", "0.5", "--seed", "3", "--dtype", "f64",
            "--device", "cpu"]
    assert cli.main(base + ["-t_f", "0.005", "-f", "e2e"]) == 0
    out = capsys.readouterr().out
    assert "# checkpoint writer:" in out and "!!! Finished !!!" in out
    states = sorted(glob.glob("e2e-state-*.pkl.zst"))
    assert len(states) == 102
    assert os.path.exists("e2e-yields.ubj.zst")
    assert os.path.exists("e2e-yields.ubjf")
    assert len(open("e2e-cluster-yields.csv").readlines()) == 103

    def last():
        st = load_state(sorted(glob.glob("e2e-state-*.pkl.zst"))[-1])
        return st, cluster_to_numpy(particles_to_cluster(st.cluster,
                                                         device="cpu"))

    _, want = last()
    assert cli.main(["-r", "e2e", "-nc", "50", "--device", "cpu"]) == 0
    _, got = last()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert cli.main(["-r", "e2e", "-t_f", "0.006", "--device", "cpu"]) == 0
    st, _ = last()
    assert st.metadata.args.final_time == pytest.approx(0.006)
    assert len(glob.glob("e2e-state-*.pkl.zst")) == 123
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-n", "8", "-rc", "1", "-f", "nocard"])


def test_console_script_and_no_jax_import():
    """The console entry point is declared, and neither the port nor the
    smoke script imports the JAX package."""
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'al26-nbody-torch = "al26_tpu_torch.cli:main"' in text
    rx = re.compile(r"^\s*(import|from)\s+(al26_tpu|jax)(\.|\s|$)")
    files = glob.glob(os.path.join(REPO, "al26_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    bad = [(f, ln) for f in files for ln in open(f) if rx.match(ln)]
    assert bad == []
