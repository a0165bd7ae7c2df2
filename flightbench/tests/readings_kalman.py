"""Readings that set the limits of `correct` for the flights fed the gate
filter's estimate (`reference/kalman_check.py`): the numbers the reference
compares for sound flights of the port, for the control, and for the port
with a fault planted underneath, at a cell's own size.

    python -m flightbench.tests.readings_kalman --seeds 1,2,3 [--fault-seeds 3] [--out readings.json]

on the card (one process).  Per seed it judges the seed's first flight.
The control is the reference computed in TF32 in the port's place (the
filter, the plant and DNN2); on the card the port's own TF32 path is read
too.  The faults (`FAULTS`), each planted while the port's sim is built
and flown:

  * truth: the planner fed the ground truth (the filter bypassed);
  * no_obs_noise: the corner noise dropped (the filter sees the true corners);
  * r_x10: the filter's measurement noise R scaled by 10;
  * unwrapped: the pitch innovation left unwrapped;
  * unchanged, half, altered: flight_check's faults (readings.py): a plant
    step that returns its state, half the lanes flown for all, DNN2's
    output moved by 0.05.

The CPU tests plant the same faults at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from flightbench.tests.readings import ROOT, _cell, half_sim, patched, unchanged_plant

CELL = "flight.main.b128.kalman"
FAULTS = ("truth", "no_obs_noise", "r_x10", "unwrapped", "unchanged", "half", "altered")


class _NoWrap:
    """The torch module with `remainder(a, p)` returning a: the filter's
    wrap `remainder(nu + p / 2, p) - p / 2` then leaves nu as it is."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def remainder(a, p):
        return a


def _sim_wrapper(wrap):
    """A replacement for make_closed_loop_sim whose sims are wrap(sim)."""
    from learningagileflight_se3_torch.sim import closed_loop

    make = closed_loop.make_closed_loop_sim

    def build(*a, **kw):
        sim = make(*a, **kw)
        run = wrap(sim)
        run.captures = sim.captures
        return run

    return build


def _half(sim):
    """half_sim, the corner noise halved with the scenarios."""
    run = half_sim(sim)

    def halved(scen, gate_noise=None, obs_noise=None, **kw):
        if obs_noise is not None:
            B = scen.shape[0]
            kw["obs_noise"] = obs_noise[: B // 2]
        return run(scen, gate_noise=gate_noise, **kw)

    return halved


@contextlib.contextmanager
def fault(kind: str, config: dict):
    """The port with fault `kind` planted inside the block (build and fly
    the sim inside it: a step graph captures what it was built with)."""
    from learningagileflight_se3_torch.sim import closed_loop, estimator
    from learningagileflight_se3_torch.utils import weights

    if kind == "truth":
        make = closed_loop.make_closed_loop_sim
        with patched(closed_loop, "make_closed_loop_sim", lambda *a, **kw: make(*a, **dict(kw, estimate_gate_motion=False))):
            yield
    elif kind == "no_obs_noise":
        def quiet(sim):
            return lambda scen, obs_noise=None, **kw: sim(scen, **kw)

        with patched(closed_loop, "make_closed_loop_sim", _sim_wrapper(quiet)):
            yield
    elif kind == "r_x10":
        make, r = estimator.make_kalman_step, config["estimator"]["r_meas"]
        with patched(closed_loop, "make_kalman_step", lambda *a, **kw: make(*a, **dict(kw, r_meas=10 * r))):
            yield
    elif kind == "unwrapped":
        with patched(estimator, "torch", _NoWrap()):
            yield
    elif kind == "unchanged":
        with patched(closed_loop, "euler_step_renorm", unchanged_plant):
            yield
    elif kind == "half":
        with patched(closed_loop, "make_closed_loop_sim", _sim_wrapper(_half)):
            yield
    elif kind == "altered":
        load = weights.load_dnn2

        def altered(*a, **kw):
            model = load(*a, **kw)
            with torch.no_grad():
                model.layers[-1].bias.add_(0.05)
            return model

        with patched(weights, "load_dnn2", altered):
            yield
    else:
        raise ValueError(f"unknown fault {kind!r}")


def kalman_readings(seeds, fault_seeds, device, overrides=None) -> dict:
    """The readings of the cell's first flight of each seed: sound, the
    control and (on the card) the port's TF32 path on the first
    `fault_seeds` seeds, and each fault there."""
    from flightbench.reference import kalman_check

    cell = _cell(CELL, overrides)
    Driver = cell.driver().Driver
    steps = cell.mix["steps"]
    out = {k: {} for k in ("sound", "control", "port_tf32") + FAULTS}

    def judge(flight, control=False):
        return kalman_check.numbers(cell.config, cell.cell, [flight], device, control=control)

    def fly(drv, s):
        drv.seed = s
        return drv._fly(drv.sim, 0, steps)

    drv = Driver(cell.cell, cell.config, cell.mix, 0, device)
    for s in seeds:
        flight = fly(drv, s)
        out["sound"][s] = judge(flight)
        if s in seeds[:fault_seeds]:
            out["control"][s] = judge(flight, control=True)
    drv.sim = None
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf = Driver(cell.cell, cell.config, cell.mix, 0, device)
            for s in seeds[:fault_seeds]:
                out["port_tf32"][s] = judge(fly(tf, s))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for kind in FAULTS:
        with fault(kind, cell.config):
            bad = Driver(cell.cell, cell.config, cell.mix, 0, device)
            for s in seeds[:fault_seeds]:
                out[kind][s] = judge(fly(bad, s))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--fault-seeds", type=int, default=3, help="how many of the seeds the faults run on")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in a.seeds.split(",")]
    t = time.perf_counter()
    out = kalman_readings(seeds, a.fault_seeds, "cuda")
    print(f"readings took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    for kind, per_seed in out.items():
        if kind == "device":
            continue
        for k in sorted({k for v in per_seed.values() for k in v}):
            vals = [v[k] for v in per_seed.values()]
            print(f"{kind:12s} {k:14s} min {min(vals):.4g} max {max(vals):.4g} n {len(vals)}")
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
