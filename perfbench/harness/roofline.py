"""The least time the card needs for the pair interactions of a step.

The arithmetic of chip_smoke.py's `_bound`, `_sfu_rate` and `_rows_bytes`,
copied: a pair costs PAIR_FLOPS FP32 operations (50 with the jerk, 30
without, as the JAX kernels' cost estimates count them) and one rsqrt,
whichever body computes it (the FMA loop, the 3xTF32 matmul reduction or a
library), against the published FP32 rate outside the tensor cores, the SFU
rate (16 rsqrt a clock per SM at the card's maximum SM clock) and the HBM
rate. The pairs are those the algorithm needs: N^2 for a full sweep, B N^2
for B group windows of N stars, K N for K predicted rows against N columns,
and for the tree's near field the real stars of each listed (target block,
source block) pair times each other (`near_interactions`), padding slots
left out: the same work reads the same share whatever kernel computes it.
"""
from __future__ import annotations

import torch

FP32_FLOPS = 67e12          # H100 SXM, FP32 outside the tensor cores, 700 W
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PAIR_FLOPS = {True: 50, False: 30}
SFU_PER_CLK = 16


def sfu_rate(sms: int, sm_clock_hz: float) -> float:
    """rsqrt results a second at the maximum SM clock."""
    return SFU_PER_CLK * sms * sm_clock_hz


def rows_bytes(b: int, n: int, with_jerk: bool, with_pot: bool) -> int:
    """Bytes a sweep of b rows against n columns must move (f32, int32):
    each input read once, each output written once."""
    per_row = 12 + 4 + (12 if with_jerk else 0)
    per_col = 12 + 4 + (12 if with_jerk else 0)
    out = 12 + (12 if with_jerk else 0) + (4 if with_pot else 0)
    return b * (per_row + out) + n * per_col


def predcols_bytes(b: int, n: int) -> int:
    """Bytes of a predicted-column call: the rows (pos, vel, id), the
    step-start columns (pos, vel, acc, jerk, mass) and acc and jerk out."""
    return b * (12 + 12 + 4 + 24) + n * (4 * 12 + 4)


def near_bytes(n: int, with_jerk: bool, listed: int) -> int:
    """Bytes of a near-field call over n real stars: each star's position
    and mass (and velocity) read once, its acc (and jerk) and potential
    written once, and the source block (int32) of each listed pair."""
    per_star = 12 + 4 + (12 if with_jerk else 0)
    out = 12 + (12 if with_jerk else 0) + 4
    return n * (per_star + out) + 4 * listed


def near_interactions(item, src, n_true: int, leaf: int):
    """(interactions, listed pairs) of a near-field work-item table (the
    program's NearItems: item [3, I] = target block, first pair, pairs;
    src [P] the source block of each listed pair): the real stars of each
    pair's target block times those of its source block, a block of `leaf`
    slots holding min(leaf, n_true - block * leaf) real stars. Items of
    the dummy target (item[0] == B) hold no pairs. Python ints."""
    item, src = item.long().cpu(), src.long().cpu()
    npairs = item[2]
    real = lambda blk: torch.clamp(n_true - blk * leaf, 0, leaf)
    per_item = torch.repeat_interleave(torch.arange(item.shape[1]), npairs)
    lead = torch.cumsum(npairs, 0) - npairs
    pidx = (item[1][per_item] + torch.arange(per_item.shape[0])
            - lead[per_item])
    inter = (real(item[0][per_item]) * real(src[pidx])).sum()
    return int(inter), int(npairs.sum())


def bound_seconds(pairs: float, with_jerk: bool, nbytes: float, sms: int,
                  sm_clock_hz: float) -> dict:
    """{pipe: seconds} for the FP32, SFU and HBM terms, and the largest as
    "bound" with its pipe as "by"."""
    terms = {"fp32": pairs * PAIR_FLOPS[with_jerk] / FP32_FLOPS,
             "sfu": pairs / sfu_rate(sms, sm_clock_hz),
             "hbm": nbytes / HBM_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return {**terms, "bound": terms[by], "by": by}


def calls_bound_seconds(calls, sms: int, sm_clock_hz: float) -> float:
    """The summed bound of recorded calls, each (pairs, with_jerk, bytes)."""
    return sum(bound_seconds(p, j, b, sms, sm_clock_hz)["bound"]
               for p, j, b in calls)
