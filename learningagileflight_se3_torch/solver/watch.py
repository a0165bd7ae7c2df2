"""Watching the kernel calls of the batched solver.

A debugging and checking aid: inside `watched_kernels(on_call)` every call
the batched solver (solver/ilqr_batched.py) makes to its K1 (rollout) and K2
(backward sweep) wrappers, and to the parallel sweep where that replaces
K2, is reported with its place in the solve, its arguments and its
outputs.  chip_smoke.py and the card tests use it to hold
the kernels against their plain versions on the inputs a path really gives
them, and to see where two paths part (`decision_record`, `first_tie`);
`kept_solutions` keeps the whole solution of an entry point's solve.  The
watchers launch nothing of their own and change no value.
"""

from __future__ import annotations

import contextlib

import torch

from learningagileflight_se3_torch.solver import ilqr_batched


@contextlib.contextmanager
def watched_kernels(on_call):
    """Report each K1 / K2 call of the batched solver inside the block:

        on_call(kind, solve, iteration, trip, args, kwargs, out)

    kind "K2": the backward sweep of DDP iteration `iteration` (from 0) of
    the `solve`-th solve of the block (from 0), `trip` None; "parallel
    sweep": the same for a solver with cfg.backward="parallel"
    (solver/parallel_riccati.py, not a kernel); "K1": line-search trip
    `trip` (from 0) of that iteration, the rollout under that sweep's gains;
    "K1 cost": an open-loop rollout at the start of a solve (the warm
    start's guard, the initial trajectory), `iteration` -1 and `trip` None.
    `args` and `kwargs` are the wrapper's own, `out` what it returned."""
    real_k1, real_k2 = ilqr_batched.rollout_forward, ilqr_batched.riccati_backward
    real_sweep = ilqr_batched.parallel_backward
    at = dict(solve=-1, iteration=-1, trip=0, kk=None)

    def sweep(kind, real):
        def call(*a, **kw):
            out = real(*a, **kw)
            at.update(iteration=at["iteration"] + 1, trip=0, kk=out[0])
            on_call(kind, at["solve"], at["iteration"], None, a, kw, out)
            return out
        return call

    def k1(*a, **kw):
        out = real_k1(*a, **kw)
        if a[2] is at["kk"]:  # the gains of the last sweep: a line-search trip
            on_call("K1", at["solve"], at["iteration"], at["trip"], a, kw, out)
            at["trip"] += 1
            return out
        if at["iteration"] >= 0 or at["solve"] < 0:  # the first rollout of a new solve
            at.update(solve=at["solve"] + 1, iteration=-1)
        at["kk"] = None
        on_call("K1 cost", at["solve"], -1, None, a, kw, out)
        return out

    ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = k1, sweep("K2", real_k2)
    ilqr_batched.parallel_backward = sweep("parallel sweep", real_sweep)
    try:
        yield
    finally:
        ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = real_k1, real_k2
        ilqr_batched.parallel_backward = real_sweep


def capture_inputs(run, solve=0, k2_call=10):
    """run() under a watcher that keeps, of the block's `solve`-th solve, the
    inputs of its `k2_call`-th K2 launch (its last, if it made fewer) and of
    the first line-search K1 launch after it.  Returns run()'s result and
    {"K2": ..., "K1": ...}, each (tensors, model arguments, keyword
    arguments), the tensors cloned."""
    got = {}

    def on_call(kind, s, k, trip, a, kw, out):
        if s != solve:
            return
        if kind == "K2" and k < k2_call:
            got["K2"] = ([x.clone() for x in a[:9]], a[9:], kw)
            got.pop("K1", None)
        elif kind == "K1" and "K2" in got and "K1" not in got:
            got["K1"] = ([x.clone() for x in a[:9]], a[9:], kw)

    with watched_kernels(on_call):
        out = run()
    return out, got


@contextlib.contextmanager
def kept_solutions():
    """Inside the block, each batched solver made through solver/ilqr.py's
    `make_batched_mpc_solver` (so the solvers of the entry points made in
    the block) appends every MPCSolution it returns to the yielded list: a
    reference, no device work."""
    from learningagileflight_se3_torch.solver import ilqr

    real, sols = ilqr.make_batched_mpc_solver, []

    def make(*a, **kw):
        solve = real(*a, **kw)

        def kept(*args, **k):
            sols.append(solve(*args, **k))
            return sols[-1]
        return kept

    ilqr.make_batched_mpc_solver = make
    try:
        yield sols
    finally:
        ilqr.make_batched_mpc_solver = real


@contextlib.contextmanager
def decision_record():
    """Inside the block, the yielded dict gets, for each DDP iteration (from
    0) of the block's last solve, the model's predicted decrease
    -(dV1 + dV2) and the costs of its line-search trials, per lane:
    {iteration: {"decrement": (B,), "trials": [(B,), ...]}}."""
    rec = {}

    def on_call(kind, solve, iteration, trip, a, kw, out):
        if kind == "K2":
            if iteration == 0:  # a new solve
                rec.clear()
            rec[iteration] = dict(decrement=-(out[2] + out[3]), trials=[])
        elif kind == "K1":
            rec[iteration]["trials"].append(out[2].detach().clone())

    with watched_kernels(on_call):
        yield rec


def first_tie(rec, lane: int, iterations: int):
    """The first DDP iteration (from 0) of a lane's solve, within its first
    `iterations`, at which the model's predicted decrease is below one ulp
    of the cost and the line search's trial costs equal one another to 8
    ulps: the accept test `Jn < J` is then decided by rounding, and two
    paths that differ by rounding alone may take different steps there.
    (iteration, text) from a `decision_record`, or None."""
    for k in range(iterations):
        trials = torch.stack(rec[k]["trials"])[:, lane].double().cpu()
        eps = torch.finfo(rec[k]["trials"][0].dtype).eps
        J, dec = float(trials.abs().max()), float(rec[k]["decrement"][lane])
        spread = float(trials.max() - trials.min())
        if dec <= eps * J and spread <= 8 * eps * J:
            return k, (f"DDP iteration {k + 1}: predicted decrease {dec:.3e} <= one ulp of the cost "
                       f"{eps * J:.3e}; the {len(trials)} trial costs {trials.min().item()!r} .. "
                       f"{trials.max().item()!r} differ by {spread:.3e}")
    return None
