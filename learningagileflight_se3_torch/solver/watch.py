"""Watching the kernel calls of the batched solver.

A debugging and checking aid: inside `watched_kernels(on_call)` every call
the batched solver (solver/ilqr_batched.py) makes to its K1 (rollout) and K2
(backward sweep) wrappers is reported with its place in the solve, its
arguments and its outputs.  chip_smoke.py and the card tests use it to hold
the kernels against their plain versions on the inputs a path really gives
them, and to see where two paths part.  The watcher launches nothing of its
own and changes no value.
"""

from __future__ import annotations

import contextlib

from learningagileflight_se3_torch.solver import ilqr_batched


@contextlib.contextmanager
def watched_kernels(on_call):
    """Report each K1 / K2 call of the batched solver inside the block:

        on_call(kind, solve, iteration, trip, args, kwargs, out)

    kind "K2": the backward sweep of DDP iteration `iteration` (from 0) of
    the `solve`-th solve of the block (from 0), `trip` None; "K1": line-search
    trip `trip` (from 0) of that iteration, the rollout under that sweep's
    gains; "K1 cost": an open-loop rollout at the start of a solve (the warm
    start's guard, the initial trajectory), `iteration` -1 and `trip` None.
    `args` and `kwargs` are the wrapper's own, `out` what it returned."""
    real_k1, real_k2 = ilqr_batched.rollout_forward, ilqr_batched.riccati_backward
    at = dict(solve=-1, iteration=-1, trip=0, kk=None)

    def k2(*a, **kw):
        out = real_k2(*a, **kw)
        at.update(iteration=at["iteration"] + 1, trip=0, kk=out[0])
        on_call("K2", at["solve"], at["iteration"], None, a, kw, out)
        return out

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

    ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = k1, k2
    try:
        yield
    finally:
        ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = real_k1, real_k2


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
