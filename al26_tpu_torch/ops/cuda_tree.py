"""The Barnes-Hut tier's exact near field: the CUDA counterpart of
al26_tpu/ops/pallas_tree.py.

One hand-written Hopper kernel in `al26_tpu_torch/csrc/tree.cu`
(`near_tiles`; its header says what it replaces, what bounds it and how
its grid is shaped), built at first use by ops.cuda_build and bound with
ctypes.

`near_field` keeps the contract of `pallas_p2p_near_field`: the [B, B]
MAC-fail mask is packed into ONE flat target-major pair list padded to
`tree.near_budget(kavg, B)` by `tree.pack_pair_list` (so the budget and
the overflow flag are the JAX package's exactly), and the pairs of each
target block are summed exactly. On a CUDA tensor it launches the kernel
in f32 (inputs cast in, outputs cast back, as the Pallas kernel does); on
a CPU tensor it runs the plain PyTorch version beside it,
`near_field_plain` (chunked gathers plus index_add_), the counterpart of
the JAX package's XLA near field. `LAUNCHES` counts kernel launches.

Self pairs are masked by the sorted slot (each star owns one slot) and
padding columns by `slot < n_true`; masks are selects, never products
with 0. The separately softened potential adds `pot_eps2` to d^2 formed
once (the JAX form r2 - eps2 + pot_eps2 cancels in f32).
"""
from __future__ import annotations

import ctypes

import torch

from ..units import G_INTERNAL
from . import cuda_build

LAUNCHES = {"near_field": 0}

# most rows a CTA runs in one pass (csrc/tree.cu loops over row chunks
# for larger leaves); the largest leaf the kernel takes
_MAX_THREADS = 256
MAX_LEAF = 1024
# plain version: pairs per chunk so a [C, L, L] temporary stays <= 2^22
_PLAIN_CHUNK_ELEMS = 1 << 22

_lib = None


def load():
    """Build csrc/tree.cu (if needed) and bind its library, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(cuda_build.build("tree.cu"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.near_field_launch.argtypes = [
        p, p, p,              # pos_s, vel_s, mass_s
        p, p, p,              # src, start, count
        i, i, i, i,           # b, leaf, n_true, threads
        f, f, f,              # eps2, pot_eps2, g
        i, i,                 # with_jerk, sep_pot
        p, p, p, p,           # acc, jerk, pot, stream
    ]
    lib.near_field_launch.restype = i
    _lib = lib
    return lib


def _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk):
    if pos_s.dim() != 3 or pos_s.shape[2] != 3:
        raise ValueError(f"pos_s has shape {tuple(pos_s.shape)}, "
                         "expected [B, L, 3]")
    b, L, _ = pos_s.shape
    if L != leaf:
        raise ValueError(f"pos_s has leaf {L}, expected {leaf}")
    if tuple(mass_s.shape) != (b, L):
        raise ValueError(f"mass_s has shape {tuple(mass_s.shape)}, "
                         f"expected {(b, L)}")
    if tuple(p2p.shape) != (b, b) or p2p.dtype != torch.bool:
        raise ValueError(f"p2p must be bool [{b}, {b}]")
    if with_jerk and vel_s is None:
        raise ValueError("with_jerk requires vel_s")
    for name, t in (("mass_s", mass_s), ("p2p", p2p), ("vel_s", vel_s)):
        if t is not None and t.device != pos_s.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{pos_s.device}")


def near_field_plain(pos_s, mass_s, p2p, n_true: int, eps2, *, leaf: int,
                     kavg: int, g: float = G_INTERNAL, pot_eps2=None,
                     vel_s=None, with_jerk: bool = False):
    """What the near-field kernel computes, in plain PyTorch, in the dtype
    of its inputs: (acc [B,L,3], jerk [B,L,3] | None, pot [B,L],
    overflow). The real pairs of the packed list are evaluated in chunks
    of [C, L, L] exact tiles and added to their target blocks in list
    order (index_add_). It reads the pair count back to the host, so it is
    for the CPU path and for comparisons, not for a step loop on a card."""
    from .tree import pack_pair_list

    _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk)
    b, L, _ = pos_s.shape
    device, dtype = pos_s.device, pos_s.dtype
    ti, sj, ok, overflow = pack_pair_list(p2p, kavg)
    n_ok = int(ok.sum())                     # real pairs come first
    acc = torch.zeros((b, L, 3), dtype=dtype, device=device)
    jerk = torch.zeros_like(acc) if with_jerk else None
    pot = torch.zeros((b, L), dtype=dtype, device=device)
    slot = torch.arange(L, device=device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (L * L))
    for s0 in range(0, n_ok, chunk):
        i_c = ti[s0:min(s0 + chunk, n_ok)].long()
        j_c = sj[s0:min(s0 + chunk, n_ok)].long()
        pos_t = pos_s[i_c]                                    # [C,L,3]
        pos_j = pos_s[j_c]
        mass_j = mass_s[j_c][:, None, :]                      # [C,1,L]
        dx = pos_j[:, None, :, 0] - pos_t[:, :, None, 0]      # [C,Lt,Ls]
        dy = pos_j[:, None, :, 1] - pos_t[:, :, None, 1]
        dz = pos_j[:, None, :, 2] - pos_t[:, :, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        grow = (i_c[:, None] * L + slot)[:, :, None]          # [C,L,1]
        gcol = (j_c[:, None] * L + slot)[:, None, :]          # [C,1,L]
        valid = (gcol != grow) & (gcol < n_true)
        inv_r = torch.where(valid, torch.rsqrt(d2 + eps2), 0.0)
        inv_r2 = inv_r * inv_r
        w = mass_j * (inv_r * inv_r2)                         # m_j / r^3
        acc.index_add_(0, i_c, g * torch.stack(
            [(w * dx).sum(2), (w * dy).sum(2), (w * dz).sum(2)], dim=-1))
        if with_jerk:
            vel_t = vel_s[i_c]
            vel_j = vel_s[j_c]
            dvx = vel_j[:, None, :, 0] - vel_t[:, :, None, 0]
            dvy = vel_j[:, None, :, 1] - vel_t[:, :, None, 1]
            dvz = vel_j[:, None, :, 2] - vel_t[:, :, None, 2]
            s = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv_r2
            jerk.index_add_(0, i_c, g * torch.stack(
                [(w * (dvx - s * dx)).sum(2), (w * (dvy - s * dy)).sum(2),
                 (w * (dvz - s * dz)).sum(2)], dim=-1))
        if pot_eps2 is not None:
            inv_r = torch.where(valid, torch.rsqrt(d2 + pot_eps2), 0.0)
        pot.index_add_(0, i_c, -g * (mass_j * inv_r).sum(2))
    return acc, jerk, pot, overflow


def pair_runs(p2p, kavg: int):
    """The packed pair list as per-target-block runs: (src int32 [P],
    start int32 [B], count int32 [B], overflow). The real pairs of target
    block t are src[start[t] : start[t] + count[t]] (the list is
    target-major); nothing is read back to the host."""
    from .tree import pack_pair_list

    b = p2p.shape[0]
    ti, sj, ok, overflow = pack_pair_list(p2p, kavg)
    count = torch.zeros(b, dtype=torch.int32, device=p2p.device)
    count.index_add_(0, ti.long(), ok.to(torch.int32))
    start = (torch.cumsum(count, 0, dtype=torch.int32) - count).contiguous()
    return sj.contiguous(), start, count, overflow


def near_field(pos_s, mass_s, p2p, n_true: int, eps2, *, leaf: int,
               kavg: int, g: float = G_INTERNAL, pot_eps2=None, vel_s=None,
               with_jerk: bool = False):
    """Kernel 3: (acc [B,L,3], jerk [B,L,3] | None, pot [B,L], overflow)
    of the sorted, padded leaf blocks over the MAC-failing pairs of `p2p`
    — the contract of pallas_p2p_near_field. CPU tensors take
    near_field_plain."""
    _check_args(pos_s, mass_s, p2p, leaf, vel_s, with_jerk)
    device = pos_s.device
    if device.type == "cpu":
        return near_field_plain(pos_s, mass_s, p2p, n_true, eps2, leaf=leaf,
                                kavg=kavg, g=g, pot_eps2=pot_eps2,
                                vel_s=vel_s, with_jerk=with_jerk)
    if device.type != "cuda":
        raise ValueError(f"near_field runs on cuda or cpu, not {device}")
    if leaf > MAX_LEAF:
        raise ValueError(f"leaf={leaf}: the near-field kernel takes at most "
                         f"{MAX_LEAF} stars per block")
    b = pos_s.shape[0]
    dtype = pos_s.dtype
    f32 = torch.float32
    pos32 = pos_s.to(f32).contiguous()
    mass32 = mass_s.to(f32).contiguous()
    vel32 = vel_s.to(f32).contiguous() if with_jerk else None
    src, start, count, overflow = pair_runs(p2p, kavg)
    acc = torch.empty((b, leaf, 3), dtype=f32, device=device)
    jerk = torch.empty_like(acc) if with_jerk else None
    pot = torch.empty((b, leaf), dtype=f32, device=device)
    threads = min(_MAX_THREADS, -(-leaf // 32) * 32)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.near_field_launch(
            pos32.data_ptr(), vel32.data_ptr() if with_jerk else None,
            mass32.data_ptr(), src.data_ptr(), start.data_ptr(),
            count.data_ptr(), b, leaf, int(n_true), threads, float(eps2),
            float(0.0 if pot_eps2 is None else pot_eps2), float(g),
            int(with_jerk), int(pot_eps2 is not None),
            acc.data_ptr(), jerk.data_ptr() if with_jerk else None,
            pot.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"near_field launch failed: cudaError {err}")
    LAUNCHES["near_field"] += 1
    return (acc.to(dtype), jerk.to(dtype) if with_jerk else None,
            pot.to(dtype), overflow)
