"""K5: the line search's first-accept rule over a grid of trial rollouts.

The solver's line search (`solver/ilqr_batched.py` `BatchedSolver.line_search`)
is a ladder of trips: each trip rolls every lane out at its own step length,
tests the cost against the expected decrease and keeps the first acceptable
trial of each lane.  The trips do not depend on each other: each rolls out
from the same trajectory and gains, and only the step length differs.  So
the solver builds the step length that each trip would give each lane
(`alpha_grid`), rolls every trial out in one K1 launch over the (trial,
lane) grid (`ops/rollout.py` `rollout_trials`), and `first_accept` replays
the ladder's recurrence over the trial axis on those costs, on every device
and drive.

CUDA kernel: `csrc/line_search.cu` (one launch; every block replays the
recurrence and gathers its share of the accepted trajectories; it holds the
state of up to `max_lanes` lanes).  Its plain version, `first_accept_plain`,
is the ladder's loop with each trip's rollout read from the grid, and the
port's one statement of that recurrence; `first_accept` takes it for CPU
tensors, and refuses a card's batch of more lanes than K5 holds.

Layout: Z (H+1,17,B), U (H,4,B), J, dV1, dV2 (B,), Zn (T,H,17,B) states
1..H of each trial, Un (T,H,4,B), Jn and alpha (T,B), ls0 int32 (B,), deep
and skip bool (B,) -> (accepted (B,), Zb, Ub, Jb, acc_idx int32 (B,),
ls_trips int32 ()).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from learningagileflight_se3_torch.ops import build

NZ, NU = 17, 4

launches = 0     # kernel launches (CUDA tensors)
plain_calls = 0  # calls of the plain version


class Ladder(NamedTuple):
    """The ladder's shape: `n_alpha` step lengths 0.5**k; a lane takes one
    rung a trip from its warm index, at most `stride` trips, and a deep lane
    `stride` rungs a trip, at most `n_deep` trips."""

    n_alpha: int
    stride: int
    n_deep: int


@functools.cache
def max_lanes(index: int) -> int:
    """The most lanes K5 takes on card `index`: their state, 9 bytes a lane,
    in one block's shared memory (25,827 on an H100)."""
    return build.library().lib.laf_line_search_max_lanes(index)


def alpha_grid(alphas, ls0, deep, n_trials: int, ladder: Ladder):
    """(n_trials, B): the step length trip j gives lane b if the lane has not
    accepted before j.  A lane takes a trip while it is live, so before trip j
    it has taken min(j, L) of them, L its first trip count at which it is out
    of rungs or trips; past L it keeps its last (clamped) rung, on which it
    may still accept while another lane keeps the search going."""
    n_alpha, stride, n_deep = ladder
    L = torch.where(deep, n_deep, torch.clamp(n_alpha - ls0, 0, stride))
    i = torch.minimum(torch.arange(n_trials, dtype=ls0.dtype, device=ls0.device)[:, None], L)
    depth = torch.where(deep, i * stride, ls0 + i)
    return alphas[torch.clamp_max(depth, n_alpha - 1).long()]


def first_accept_plain(Z, U, J, Zn, Un, Jn, alpha, dV1, dV2, ls0, deep, skip, ladder: Ladder):
    """Plain PyTorch version: the ladder's loop, trip j's rollout read from
    row j of the grid.  A trip is gated by whether any lane is live in the
    search (`trip_go`): past that it accepts nothing and counts no trip."""
    global plain_calls
    plain_calls += 1
    n_alpha, stride, n_deep = ladder
    tiny = 1e-300 if J.dtype == torch.float64 else 1e-30
    max_trips = torch.where(deep, n_deep, stride)
    depth = lambda i: torch.where(deep, i * stride, ls0 + i)  # noqa: E731
    live = lambda acc, i: (~acc) & (depth(i) < n_alpha) & (i < max_trips)  # noqa: E731

    accepted = skip
    i = torch.zeros_like(ls0)
    Zb, Ub, Jb = Z, U, J
    for j in range(Jn.shape[0]):
        active = live(accepted, i)
        trip_go = active.any()
        a = alpha[j]
        expected = -(a * dV1 + a * a * dV2)
        # not masked by `live` (nor is the JAX solver's): a lane out of
        # trips still accepts while another lane keeps the search going
        ok = (
            (Jn[j] < J)
            & (expected > 0)
            & ((J - Jn[j]) / torch.clamp_min(expected, tiny) > 0.1)
            & ~accepted
            & trip_go
        )
        Zb = torch.where(ok, torch.cat([Z[:1], Zn[j]]), Zb)
        Ub = torch.where(ok, Un[j], Ub)
        Jb = torch.where(ok, Jn[j], Jb)
        accepted = accepted | ok
        i = i + active.to(i.dtype)
    acc_idx = torch.where(
        accepted,
        torch.clamp_max(torch.where(deep, (i - 1) * stride, ls0 + i - 1), n_alpha - 1),
        ls0,
    )
    return accepted, Zb, Ub, Jb, acc_idx, i.max()


def first_accept(Z, U, J, Zn, Un, Jn, alpha, dV1, dV2, ls0, deep, skip, ladder: Ladder, count=None):
    """K5 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; a ValueError for more CUDA lanes than
    `max_lanes`.  count (int32 (2,) on the device, or None): the kernel adds
    [1, the trips] where the search runs any trip."""
    global launches
    T, H = Zn.shape[0], Zn.shape[1]
    B = J.shape[0]
    floats = dict(Z=Z, U=U, J=J, Zn=Zn, Un=Un, Jn=Jn, alpha=alpha, dV1=dV1, dV2=dV2)
    shapes = dict(Z=(H + 1, NZ, B), U=(H, NU, B), J=(B,), Zn=(T, H, NZ, B), Un=(T, H, NU, B), Jn=(T, B),
                  alpha=(T, B), dV1=(B,), dV2=(B,))
    device, dtype = build.check_tensors("first_accept", shapes, floats)
    for name, t, want in (("ls0", ls0, torch.int32), ("deep", deep, torch.bool), ("skip", skip, torch.bool)):
        if t.dtype != want or tuple(t.shape) != (B,) or t.device != device or not t.is_contiguous():
            raise ValueError(f"first_accept: {name} must be a contiguous {want} ({B},) tensor on {device}")
    if device.type == "cpu":
        return first_accept_plain(Z, U, J, Zn, Un, Jn, alpha, dV1, dV2, ls0, deep, skip, ladder)
    limit = max_lanes(torch.cuda.current_device() if device.index is None else device.index)
    if B > limit:
        raise ValueError(f"first_accept: K5 holds at most {limit} lanes on {device}, not {B}")
    if count is not None and (count.dtype != torch.int32 or count.shape != (2,) or count.device != device):
        raise ValueError(f"first_accept: count must be an int32 (2,) tensor on {device}")
    Zb, Ub, Jb = torch.empty_like(Z), torch.empty_like(U), torch.empty_like(J)
    accepted = torch.empty((B,), dtype=torch.bool, device=device)
    acc_idx = torch.empty((B,), dtype=torch.int32, device=device)
    ls_trips = torch.empty((), dtype=torch.int32, device=device)
    fn = getattr(build.library().lib, f"laf_line_search_{'f64' if dtype == torch.float64 else 'f32'}")
    ptrs = [t.data_ptr() for t in (*floats.values(), ls0, deep, skip, Zb, Ub, Jb, accepted, acc_idx, ls_trips)]
    with torch.cuda.device(device):
        rc = fn(T, H, B, *ladder, *ptrs, None if count is None else count.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_accept: CUDA launch failed with cudaError {rc}")
    launches += 1
    return accepted, Zb, Ub, Jb, acc_idx, ls_trips
