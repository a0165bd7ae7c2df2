"""What decides `correct` for batched solves: each judged answer (controls
U, cost J, exit status a lane) held by the plain reference in float64 to
what it says, on the problem the benchmark made.

  cost_gap_max  the widest |J - J_ref(U)| / (1 + |J_ref(U)|) over every
                lane of the judged answers: the cost reported is the cost of
                the controls returned;
  polish_share  over a sample of lanes drawn from the seed, the share whose
                controls the reference's own solver (`ddp.py`, float64,
                `polish_iters` iterations from U) improves by more than
                `polish_tol` of 1 + |J_ref(U)|: the answer is a local optimum
                of its problem, to the solver's tolerance, and not a start,
                an early exit or a wrong direction's end;
  bound_excess  the largest step of a control past its bound, in U's own
                precision (an exact comparison).

A lane whose reported cost and reference cost are not both finite, or
both not, counts as an infinite cost gap; a sampled lane whose controls
cost the reference an infinite or undefined cost counts as improvable.
"""

from __future__ import annotations

import numpy as np
import torch

from flightbench.reference import ddp
from flightbench.reference.plain import Arith, trajectory_cost


def sample(seed: int, n_answers: int, batch: int, per_answer: int) -> list:
    """The lanes (index arrays) of each judged answer that the polish
    judges, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2**64, 11])
    return [np.sort(rng.choice(batch, size=min(per_answer, batch), replace=False)) for _ in range(n_answers)]


def cost_gaps(problem: tuple, U, J, config: dict):
    """(the cost gap (B,), the bound excess) of one answer on the problem's
    device."""
    dev = problem[0].device
    U, J = U.to(dev), J.to(dev)
    lb, ub = config["bounds"]["u_lb"], config["bounds"]["u_ub"]
    with torch.no_grad():
        J_ref = trajectory_cost(*problem[:2], U, *problem[2:], config, Arith("f64"))
    J = J.to(J_ref.dtype)
    fin, fin_ref = torch.isfinite(J), torch.isfinite(J_ref)
    gap = torch.where(fin & fin_ref, (J - J_ref).abs() / (1.0 + J_ref.abs()), torch.zeros_like(J_ref))
    gap = torch.where(fin != fin_ref, torch.full_like(gap, float("inf")), gap)
    excess = torch.maximum(U - torch.tensor(ub, dtype=U.dtype, device=dev),
                           torch.tensor(lb, dtype=U.dtype, device=dev) - U).clamp_min(0.0)
    return gap, float(excess.max())


def take(problem: tuple, lanes) -> tuple:
    idx = torch.as_tensor(lanes, device=problem[0].device)
    return tuple(a[idx] for a in problem)


def polish_gains(problems: list, answers: list, lanes: list, config: dict, iters: int):
    """The reference's relative gain from each sampled lane's controls,
    all sampled lanes polished together: (B_sampled,) float64."""
    picked = [(take(p, ln), a[0].to(p[0].device)[torch.as_tensor(ln, device=p[0].device)])
              for p, a, ln in zip(problems, answers, lanes) if a is not None]
    if not picked:
        return torch.zeros(0, dtype=torch.float64)
    prob = tuple(torch.cat([q[0][i] for q in picked]) for i in range(6))
    U = torch.cat([q[1] for q in picked])
    with torch.no_grad():
        J0, J1 = ddp.polish(prob, U, config, iters)
    gain = (J0 - J1) / (1.0 + J0.abs())
    return torch.where(torch.isfinite(gain), gain, torch.full_like(gain, float("inf")))


def numbers(problems: list, answers: list, config: dict, lanes: list, check: dict) -> dict:
    """The three numbers over the judged answers (None: not due)."""
    gaps, excess = [], 0.0
    for p, a in zip(problems, answers):
        if a is None:
            continue
        gap, ex = cost_gaps(p, a[0], a[1], config)
        gaps.append(gap)
        excess = max(excess, ex)
    gain = polish_gains(problems, answers, lanes, config, check["polish_iters"])
    return {
        "cost_gap_max": float(torch.cat(gaps).max()),
        "polish_share": float((gain > check["polish_tol"]).double().mean()) if gain.numel() else 0.0,
        "bound_excess": excess,
    }


def reference_answers(problems: list, lanes: list, config: dict, solver: dict, prec: str) -> tuple:
    """The reference's own cold solve in `prec` ("tf32": the control) of
    the sampled lanes, put in the port's place: ([problem], [answer],
    [lanes]) to judge as the port's answers are.  Lanes are independent
    problems, so the sampled lanes alone are solved, in one batch."""
    qs = [take(p, ln) for p, ln in zip(problems, lanes)]
    prob = tuple(torch.cat([q[i] for q in qs]) for i in range(6))
    with torch.no_grad():
        U, J, st = ddp.solve(prob, config, solver, Arith(prec))
    return [prob], [(U, J, st)], [np.arange(prob[0].shape[0])]
