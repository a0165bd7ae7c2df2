"""The benchmark's arithmetic: the card's published peaks, the kernels'
operations and bytes, rooflines and percentiles.

Copied from the port's `chip_smoke.py` (`bound`, `K1_FLOPS`, `K2_FLOPS`),
so that a later change there does not move the yardstick.  Peaks: one H100
SXM, NVIDIA's data sheet, dense, at 700 W.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Operations per scenario and solver step, counted from the kernels' code (a
# multiply and an add are two).  K1, the rollout with cost: z - z_ref 17, the
# gains 144, the stage cost 150, the Euler step 110.  K2, the backward sweep:
# the Vzz update 5.5k, M = Vzz A and Qzz = A^T M 1.3k each, the value
# recursion 0.9k, the K solve 0.8k, B^T Vzz 0.6k, Quz and Quu 0.5k, the rest
# 1.0k, and 3 boxQP iterations of 350.
K1_FLOPS = 420
K2_FLOPS = 13_000

NZ, NU = 17, 4


def k1_bytes(B: int, H: int, word: int = 4) -> int:
    """K1 reads Z_ref (H,17,B), U_ref and kk (H,4,B), KK (H,4,17,B), t_w
    (H,1,B), alpha (1,B), goal and tra_pos (3,B), tra_quat (4,B) once and
    writes Zn (H,17,B), Un (H,4,B), cost (B)."""
    read = H * B * (NZ + NU + NU + NU * NZ + 1) + B * (1 + 3 + 3 + 4)
    write = H * B * (NZ + NU) + B
    return (read + write) * word


def k2_bytes(B: int, H: int, word: int = 4) -> int:
    """K2 reads ZU (H,21,B), t_w (H,1,B), goal and tra_pos (3,B), Hatt
    (4,4,B), att0 (1,B), phi_z (17,B), phi_zz (17,17,B), reg (1,B) once and
    writes kk (H,4,B), KK (H,4,17,B), dV1, dV2, fail, pg (B each)."""
    read = H * B * (NZ + NU + 1) + B * (3 + 3 + 16 + 1 + NZ + NZ * NZ + 1)
    write = H * B * (NU + NU * NZ) + 4 * B
    return (read + write) * word


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the f32 peak and the bytes at the memory rate."""
    return max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> Optional[float]:
    """The bound's share of a measured time, in %; None without a time."""
    if seconds <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between order statistics; nan
    for no values."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# the port's kernels, by the names the profiler gives them
K1_KERNEL = "rollout_kernel"         # csrc/rollout.cu
K2_KERNEL = "riccati_fused_kernel"   # csrc/riccati_fused.cu
