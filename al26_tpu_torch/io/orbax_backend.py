"""Device-state checkpoint tree on torch.distributed.checkpoint (the port's
counterpart of al26_tpu/io/orbax_backend.py; the module and function
names are the JAX package's).

The reference-format files (io.checkpoint) are host formats: the whole
cluster is pickled by one process. This module adds a second, optional
backend for mesh runs (SimConfig.orbax_dir): the SimState as a DCP tree
(torch.distributed.checkpoint), which every rank of the run takes part
in and which loads straight onto the run's devices. The driver keeps
writing the reference-format files for the analysis pipeline.

Layout per save, as in the JAX package:  <dir>/<step>/  (the DCP tree of
the SimState, one entry per tensor: "cluster.<field>", "time",
"step_count") + <dir>/<step>.cfg.json (the resolved SimConfig), which
rank 0 writes atomically (os.replace) after the tree as the step's
completeness marker.

Deliberate difference: an orbax tree and a DCP tree do not read each
other (the port imports neither orbax nor jax). The reference-format
files still go both ways.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..state import Cluster, SimState


def _path(orbax_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(orbax_dir), str(step))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def state_dict(state: SimState) -> dict:
    """The SimState as the flat {name: tensor} dict a DCP tree holds."""
    d = {f"cluster.{f.name}": getattr(state.cluster, f.name)
         for f in dataclasses.fields(Cluster)}
    d["time"] = state.time
    d["step_count"] = state.step_count
    return d


def from_state_dict(d: dict) -> SimState:
    """Inverse of state_dict."""
    cluster = Cluster(**{f.name: d[f"cluster.{f.name}"]
                         for f in dataclasses.fields(Cluster)})
    return SimState(cluster=cluster, time=d["time"],
                    step_count=d["step_count"])


def save_sharded_state(orbax_dir: str, step: int, state: SimState,
                       cfg) -> None:
    """Write the SimState as a DCP tree; every rank of the run takes part
    (each rank holds the whole state, and DCP stores each tensor once). A
    tree already at this step is replaced. The resolved config goes into
    the JSON sidecar, the step's completeness marker."""
    path = _path(orbax_dir, step)
    if _rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.isdir(path):
            shutil.rmtree(path)
    _barrier()
    dcp.save(state_dict(state), checkpoint_id=path)
    _barrier()
    if _rank() == 0:
        d = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in cfg.to_dict().items()}
        # atomic: latest_step skips steps without a sidecar, so a crash
        # between the tree and this write cannot break the next resume
        sidecar = path + ".cfg.json"
        with open(sidecar + ".tmp", "w") as f:
            json.dump(d, f)
        os.replace(sidecar + ".tmp", sidecar)
    _barrier()


def latest_step(orbax_dir: str) -> Optional[int]:
    """Highest step with a COMPLETE save (tree + cfg sidecar)."""
    if not os.path.isdir(orbax_dir):
        return None
    steps = [int(d) for d in os.listdir(orbax_dir)
             if d.isdigit()
             and os.path.exists(os.path.join(orbax_dir, d + ".cfg.json"))]
    return max(steps) if steps else None


def drop_steps_above(orbax_dir: str, step: int) -> None:
    """Delete the steps above `step` (the counterpart of the driver's
    _drop_stale_state_files): a -nc resume rewrites the timeline, and a
    later latest_step must not pick the abandoned one."""
    if not os.path.isdir(orbax_dir):
        return
    for d in os.listdir(orbax_dir):
        name = d[:-len(".cfg.json")] if d.endswith(".cfg.json") else d
        if name.isdigit() and int(name) > step:
            p = os.path.join(orbax_dir, d)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)


def load_sharded_state(orbax_dir: str, step: Optional[int] = None,
                       template: Optional[SimState] = None):
    """Restore (state, cfg_dict, step). With `template` (a SimState of the
    same shapes, e.g. the freshly initialised one on the run's device) the
    tensors load straight into copies of the template's, on its devices;
    without one they load onto the CPU with the stored shapes and dtypes."""
    if step is None:
        step = latest_step(orbax_dir)
        if step is None:
            raise IOError(f"no orbax checkpoints under {orbax_dir!r}")
    path = _path(orbax_dir, step)
    if template is not None:
        d = {k: torch.empty_like(t) for k, t in state_dict(template).items()}
    else:
        meta = dcp.FileSystemReader(path).read_metadata()
        d = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.state_dict_metadata.items()}
    dcp.load(d, checkpoint_id=path)
    with open(path + ".cfg.json") as f:
        cfg_dict = json.load(f)
    if isinstance(cfg_dict.get("mesh_shape"), list):
        cfg_dict["mesh_shape"] = tuple(cfg_dict["mesh_shape"])
    return from_state_dict(d), cfg_dict, step
