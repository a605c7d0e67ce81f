"""Multi-device scaling on torch.distributed: the O(N^2) interaction
matrix split by row blocks (port of al26_tpu/parallel/sharded.py).

SPMD with one rank per device. A run is launched with

    torchrun --nproc_per_node D -m al26_tpu_torch.cli --mesh_shape D ...

and each rank computes on cuda:LOCAL_RANK (NCCL) or, with `--device cpu`,
on the CPU (gloo). A mesh is a `torch.distributed.device_mesh.DeviceMesh`
with the JAX package's axis names (`("rows",)` here, `("ens",)` and
`("ens", "rows")` in parallel.ensemble); collectives run on its
per-dimension groups. A plain process (no torchrun) that asks for a mesh
of size 1 initialises a world of one itself, through a FileStore in a
temporary directory; a mesh larger than the world raises ValueError.

Deliberate difference from the JAX package: every rank holds the WHOLE
state, and only the pairwise work is split. The JAX package lays per-star
arrays out row-sharded and lets GSPMD place the collectives the
deposition physics needs; torch has no such partitioner, and the state
(~100 B a star) is small next to the O(N^2) work. So:

  * a full sweep is computed by row block (`_local_rows_force`: rows
    [r N/D, (r+1) N/D) against all N columns, through kernel 1, or 1c
    under the entry points' default use_mxu=True, on the card) and the
    blocks are all-gathered;
  * a K-row subcycle evaluation is computed by column slice
    (`_partial_rows_force`: the K replicated rows against this rank's N/D
    columns) and all-reduced (SUM);
  * integration and physics run on every rank, on the same bits.

The sums differ from the one-device run only in summation order, as the
JAX mesh's do. Rank 0 writes the reference-format files, with no gather.

Rank agreement. The replicated copies stay bit-identical only if every
replicated op is deterministic, and each is: the kernels sum their column
splits in a fixed order; a collective hands every rank the same bits;
torch's reductions are deterministic; the step's two scatters on the card
path (sim/step.py's index_add of the natal kicks, which adds exact zeros
at the repeated padding slots, and ops/deposition.py's scatter_reduce
"amax" of the SN candidacy, an order-free maximum) give the same bits in
any order; and ops/cuda_tree.py's index_add_ sums belong to the plain
near field, which runs on the CPU only. So no end-of-step exchange is
needed, and the tests check that every rank ends on the same bits.

Each function splits into a local body, `(rank, world, tensors)` -> this
rank's partial result, and a thin collective wrapper, so the tests and
chip_smoke.py can run all D ranks' arithmetic in one process.
"""
from __future__ import annotations

import os
import tempfile
from typing import Tuple

import torch
import torch.distributed as dist

from ..ops import cuda_nbody
from ..ops.nbody import _row_block_acc_jerk_pot
from ..state import map_tensors
from ..units import G_INTERNAL

ROW_AXIS = "rows"

_MESHES = {}


def local_device(device="cuda") -> torch.device:
    """The rank's device: "cuda" means cuda:LOCAL_RANK (torchrun sets it;
    0 in a plain process)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_world(size: int, device="cuda") -> None:
    """Make sure a default process group of `size` ranks exists: NCCL for
    a CUDA device (the rank's device set first), gloo for the CPU. Under
    torchrun the group comes from its environment; a plain process may
    only ask for a world of one, which it initialises itself through a
    FileStore in a temporary directory."""
    device = local_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
        if not launched and size != 1:
            raise ValueError(
                f"a mesh of {size} devices needs a world of {size} ranks, "
                f"one a device: launch with torchrun --nproc_per_node "
                f"{size}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if launched:
            dist.init_process_group(backend)
        else:
            store = dist.FileStore(
                os.path.join(tempfile.mkdtemp(prefix="al26-world-"),
                             "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        # meshes of an earlier, destroyed group are stale
        _MESHES.clear()
    elif device.type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(
            f"a CUDA mesh runs its collectives on NCCL; the process group "
            f"was initialised with {dist.get_backend()}")
    world = dist.get_world_size()
    if size > world:
        raise ValueError(
            f"a mesh of {size} devices needs {size} ranks, the world has "
            f"{world}: launch with torchrun --nproc_per_node {size}")
    if size < world:
        raise ValueError(
            f"a mesh of {size} devices in a world of {world} ranks: the "
            f"mesh spans every rank (torchrun --nproc_per_node {size})")


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                device="cuda"):
    """The DeviceMesh of `shape` with axis `names` over the world, made
    once per (device type, shape, names)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = local_device(device)
    shape = tuple(int(s) for s in shape)
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: every axis needs >= 1 "
                         "device")
    size = 1
    for s in shape:
        size *= s
    init_world(size, device)
    key = (device.type, shape, tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device.type, shape,
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on under `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_rank(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's coordinate, size) along the mesh axis `axis`."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(
        axis))


def all_gather_cat(t: torch.Tensor, group, world: int,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in rank order."""
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_sum(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """The SUM of every rank's `t` (in place), on every rank."""
    if world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def make_mesh(n_devices: int | None = None, axis: str = ROW_AXIS,
              device="cuda"):
    """1-D device mesh of `n_devices` ranks (default: the whole world, or
    a world of one in a plain process), axis name `axis`."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return device_mesh((n_devices,), (axis,), device)


def pad_to_multiple(n: int, d: int) -> int:
    return -(-n // d) * d


def _block(n: int, world: int) -> int:
    if n % world:
        raise ValueError(f"{n} stars do not divide across {world} ranks "
                         "(pad with zero-mass stars)")
    return n // world


def kernel_here(pos: torch.Tensor, use_kernel: bool | None) -> bool:
    """Do the local bodies run the kernels' wrappers (default: where the
    direct-sum kernels run, cuda_nbody.use_kernel) or the plain row block
    of ops.nbody (the JAX package's arithmetic, in the input dtype)?"""
    if use_kernel is None:
        return cuda_nbody.use_kernel(pos.shape[0], pos.dtype, pos.device)
    return use_kernel


def slice_ids(row_ids: torch.Tensor, start: int, n_cols: int):
    """The rows' ids as the kernels must see them against the column slice
    [start, start + n_cols): a row of the slice gets its local column
    index (its self pair is masked); every other row gets n_cols, an id
    that matches no local column (not id - start: the kernels take every
    id < 0 as padding, and kernel 1b would drop the row's forces); a
    padding row (-1) stays -1."""
    local = row_ids.long() - start
    outside = (local < 0) | (local >= n_cols)
    local = torch.where(outside, n_cols, local)
    return torch.where(row_ids < 0, -1, local).to(torch.int32)


def _rows_force(pos_rows, vel_rows, row_ids, pos, vel, mass, eps2, g, *,
                col0: int, with_jerk: bool, with_pot: bool, pot_eps2,
                kernel: bool, use_mxu: bool = True):
    """(acc, jerk, pot) of rows with global ids `row_ids` against the
    columns pos/vel/mass, whose global ids start at col0: kernel 1 / 1c
    (the wrapper: a launch on the card, its plain version on the CPU) with
    the ids mapped by slice_ids, or the plain row block in the input
    dtype."""
    if kernel:
        ids = slice_ids(row_ids, col0, pos.shape[0])
        return cuda_nbody.kernel_acc_jerk_pot_rows(
            pos_rows, vel_rows, ids, pos, vel, mass, float(eps2), g,
            with_jerk=with_jerk, pot_eps2=pot_eps2, use_mxu=use_mxu,
            with_pot=with_pot)
    return _row_block_acc_jerk_pot(
        pos_rows, vel_rows, pos, vel, mass, eps2, g, row_ids,
        pot_eps2=pot_eps2, col_offset=col0, with_jerk=with_jerk,
        with_pot=with_pot)


def _local_rows_force(rank: int, world: int, pos, vel, mass, eps2,
                      g: float = G_INTERNAL, with_jerk: bool = True,
                      pot_eps2: float | None = None,
                      use_kernel: bool | None = None,
                      use_mxu: bool = True):
    """Local body of the full sweep: rank `rank`'s row block [r N/D,
    (r+1) N/D) with its global ids against all N columns. `pot_eps2`
    softens the potential separately, so ONE sweep serves the integrator
    and the virial radius. Returns the block's (acc, jerk, pot)."""
    n = pos.shape[0]
    block = _block(n, world)
    start = rank * block
    rows = torch.arange(start, start + block, dtype=torch.int32,
                        device=pos.device)
    sl = slice(start, start + block)
    return _rows_force(pos[sl], vel[sl], rows, pos, vel, mass, eps2, g,
                       col0=0, with_jerk=with_jerk, with_pot=True,
                       pot_eps2=pot_eps2, kernel=kernel_here(pos, use_kernel),
                       use_mxu=use_mxu)


def sharded_acc_jerk_pot(pos, vel, mass, mesh, eps2=0.0,
                         g: float = G_INTERNAL, axis: str = ROW_AXIS,
                         pot_eps2: float | None = None,
                         with_jerk: bool = True):
    """(acc, jerk, pot) of every star over the mesh: this rank's row block
    (_local_rows_force), all-gathered so every rank holds the whole
    result. With `pot_eps2` the potential is softened separately, so the
    mesh step needs no second sweep for the virial radius."""
    rank, world = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    a, j, p = _local_rows_force(rank, world, pos, vel, mass, eps2, g,
                                with_jerk, pot_eps2)
    return tuple(all_gather_cat(t, group, world) for t in (a, j, p))


def make_sharded_force(mesh, mass, eps2=0.0, g: float = G_INTERNAL,
                       axis: str = ROW_AXIS):
    """`force_fn(pos, vel) -> (acc, jerk)` that splits the pairwise sweep
    by row blocks over `mesh` (N must divide by the mesh size)."""

    def force_fn(pos, vel):
        a, j, _ = sharded_acc_jerk_pot(pos, vel, mass, mesh, eps2, g, axis)
        return a, j

    return force_fn


def _partial_rows_force(rank: int, world: int, pos_rows, vel_rows, row_ids,
                        pos, vel, mass, eps2, g: float = G_INTERNAL,
                        use_kernel: bool | None = None,
                        use_mxu: bool = True):
    """Local body of the subcycle's row sweep: the K rows (global ids
    `row_ids`, from any shard) against rank `rank`'s column slice
    [r N/D, (r+1) N/D). Returns the slice's partial (acc, jerk); the sum
    over the ranks is the rows' force."""
    n = pos.shape[0]
    block = _block(n, world)
    start = rank * block
    sl = slice(start, start + block)
    a, j, _ = _rows_force(pos_rows, vel_rows, row_ids, pos[sl], vel[sl],
                          mass[sl], eps2, g, col0=start, with_jerk=True,
                          with_pot=False, pot_eps2=None,
                          kernel=kernel_here(pos, use_kernel),
                          use_mxu=use_mxu)
    return a, j


def make_sharded_force_rows(mesh, mass, eps2=0.0, g: float = G_INTERNAL,
                            axis: str = ROW_AXIS):
    """`force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` for the block-timestep Hermite subcycle under a mesh: the
    K fast rows (replicated) against this rank's N/D column slice, then an
    all-reduce (SUM) — O(K N / D) pair work a rank a substep. Self pairs
    are masked by global id."""
    rank, world = axis_rank(mesh, axis)
    group = mesh.get_group(axis)

    def force_rows_fn(pr, vr, ids, p_all, v_all):
        a, j = _partial_rows_force(rank, world, pr, vr, ids, p_all, v_all,
                                   mass, eps2, g)
        return (all_reduce_sum(a.contiguous(), group, world),
                all_reduce_sum(j.contiguous(), group, world))

    return force_rows_fn


def sharded_potential_energy(pos, mass, mesh, eps2=0.0,
                             g: float = G_INTERNAL, axis: str = ROW_AXIS):
    """Total potential energy: each rank's row block, then one all-reduce
    (SUM) of the partial energies."""
    rank, world = axis_rank(mesh, axis)
    n = pos.shape[0]
    _, _, pot_l = _local_rows_force(rank, world, pos, torch.zeros_like(pos),
                                    mass, eps2, g, with_jerk=False)
    block = _block(n, world)
    m_l = mass[rank * block:(rank + 1) * block]
    u = (0.5 * torch.sum(m_l * pot_l)).reshape(1)
    return all_reduce_sum(u, mesh.get_group(axis), world)[0]


def shard_state_rows(state, mesh, axis: str = ROW_AXIS):
    """Place a SimState (or any dataclass of tensors) for a run over
    `mesh`: every rank holds the WHOLE state on its own device (see the
    module docstring); the name is the JAX package's, whose arrays are
    row-sharded instead."""
    device = mesh_device(mesh)
    return map_tensors(lambda t: t.to(device), state)
