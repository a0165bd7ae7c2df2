"""Readings that set the limits of `correct`: the numbers the reference
compares, for sound runs of the port, for the control, and for the port
with a fault planted underneath, at a cell's own size.

    python -m flightbench.tests.readings --workload <cell> --seeds 1,2,3 \\
        [--fault-seeds 3] [--out readings.json]

on the card (one process: set-up is paid once).  Per seed it judges what a
run judges: a solve cell's distinct batches, one answer each; a flight
cell's flight of the seed.  The control is the reference computed in TF32
in the port's place; a flight cell also reads the port with its own TF32
path switched on.  The faults:

  * unchanged: a step that returns its state unchanged (the DDP
    iteration; the flight's plant step);
  * half: half of the batch solved or flown, its answers standing for the
    other half too;
  * altered: an answer altered where it is produced (the solve's first
    controls set to the cold start's; DNN2's output moved by 0.05);
  * early exit (solve cells): the DDP loop exits after 16 iterations (its
    configuration's cap; a third of a solve's mean).

A solve cell also reads the reference's own float64 solve in the port's
place (it has to pass), and its control is the reference's own solve in
TF32, both on the sampled lanes.

The CPU tests call the same functions at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _cell(name: str, overrides=None):
    from flightbench import harness

    cell = harness.Cell(name, harness.load_json(ROOT, "BENCHMARK.json"))
    for key, upd in (overrides or {}).items():
        (cell.mix if key == "mix" else cell.cell[key]).update(upd)
    return cell


@contextlib.contextmanager
def patched(obj, name: str, value):
    """obj.name = value inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# ------------------------------------------------------------------ faults
def unchanged_iteration(self, s, p, go, sync=False):
    """The DDP iteration returning its state unchanged (its count of
    iterations aside, so that the loop still ends at the cap)."""
    return s._replace(it=s.it + go.to(s.it.dtype))


def half_solver(solve):
    """A solve of the first half of the batch whose answers stand for the
    second half too."""
    from learningagileflight_se3_torch.solver.ilqr import MPCSolution

    def run(*args, **kw):
        B = args[0].shape[0]
        sol = solve(*(a[: B // 2] for a in args), **kw)
        twice = lambda a: torch.cat([a, a])[:B] if a.dim() and a.shape[0] == B // 2 else a  # noqa: E731
        return MPCSolution(*(twice(f) for f in sol))

    return run


def altered_solver(solve, lb: float, ub: float):
    """A solve whose first controls are altered to the cold start's as it
    returns them."""
    def run(*args, **kw):
        sol = solve(*args, **kw)
        U = sol.control_traj.clone()
        U[:, 0] = 0.5 * (lb + ub)
        return sol._replace(control_traj=U)

    return run


def unchanged_plant(x, u, dt, params):
    """The plant step returning its state unchanged."""
    return x + 0.0 * u.sum(dim=-1, keepdim=True)


def half_sim(sim):
    """A flight of the first half of the lanes whose log stands for the
    other half too."""
    def run(scen, gate_noise=None, **kw):
        B = scen.shape[0]
        log = sim(scen[: B // 2], gate_noise=None if gate_noise is None else gate_noise[: B // 2], **kw)
        return log._replace(**{k: torch.cat([v, v])[:B] for k, v in log._asdict().items()
                               if torch.is_tensor(v) and v.dim() and v.shape[0] == B // 2})

    run.captures = sim.captures
    return run


# ------------------------------------------------------------------ solve cells
def early_exit_factory(make, iters: int = 16):
    """A solver factory whose solver's loop exits after `iters` DDP
    iterations (its configuration's cap)."""
    import dataclasses

    def build(params, weights, cfg, *a, **kw):
        return make(params, weights, dataclasses.replace(cfg, max_iters=iters), *a, **kw)

    return build


def _solve_answers(drv, problems):
    out = []
    for p in problems:
        U, J, st, _, _ = drv._fetch(drv.solve(*p))
        out.append((U.clone(), J.clone(), st.clone()))
    return out


def solve_stats(problems, answers, lanes, cell) -> dict:
    """The cell's numbers, with the spread of the readings they are taken
    from: the cost gap's and the polish gain's quantiles, the shares of
    lanes a polish improves by more than 1e-3 to 1e-1, the exit statuses."""
    from flightbench.reference import solve_check
    from flightbench.yardstick import percentile

    check = cell.cell["check"]
    out = solve_check.numbers(problems, answers, cell.config, lanes, check)
    gaps = torch.cat([solve_check.cost_gaps(p, a[0], a[1], cell.config)[0] for p, a in zip(problems, answers)])
    gain = solve_check.polish_gains(problems, answers, lanes, cell.config, check["polish_iters"])
    st = torch.cat([a[2].to(torch.int64).cpu() for a in answers])
    out.update({f"gap_p{q}": percentile(gaps.tolist(), q) for q in (50, 99)})
    out.update({f"gain_p{q}": percentile(gain.tolist(), q) for q in (50, 90, 99)})
    out["gain_max"] = float(gain.max())
    out.update({f"gain_share_{t:g}": float((gain > t).double().mean()) for t in (1e-3, 3e-3, 1e-2, 3e-2, 1e-1)})
    out.update({f"status_{k}": float((st == k).double().mean()) for k in range(5)})
    return out


def solve_readings(name: str, seeds, fault_seeds, device, overrides=None, kinds=None) -> dict:
    from flightbench import traffic
    from flightbench.reference import solve_check
    from learningagileflight_se3_torch.solver import ilqr, ilqr_batched

    cell = _cell(name, overrides)
    Driver = cell.driver().Driver
    drv = Driver(cell.cell, cell.config, cell.mix, 0, device)
    kinds = kinds or ("sound", "control", "reference_f64", "unchanged", "half", "altered", "early_exit")
    out = {k: {} for k in kinds}
    want = lambda k: k in kinds  # noqa: E731
    batches = {s: traffic.solve_batches(cell.mix, cell.config, s, device) for s in seeds}
    lanes = {s: solve_check.sample(s, len(batches[s]), cell.mix["batch"], cell.cell["check"]["sample"])
             for s in seeds}
    for s in seeds if want("sound") else ():
        out["sound"][s] = solve_stats(batches[s], _solve_answers(drv, batches[s]), lanes[s], cell)
    for s in seeds[:fault_seeds]:
        for kind, prec in (("control", "tf32"), ("reference_f64", "f64")) if want("control") else ():
            out[kind][s] = solve_stats(*solve_check.reference_answers(batches[s], lanes[s], cell.config,
                                                                      cell.cell["solver"], prec), cell)
    lb, ub = cell.config["bounds"]["u_lb"], cell.config["bounds"]["u_ub"]
    base = drv.solve
    for kind, wrap in (("half", half_solver), ("altered", lambda f: altered_solver(f, lb, ub))):
        if not want(kind):
            continue
        drv.solve = wrap(base)
        for s in seeds[:fault_seeds]:
            out[kind][s] = solve_stats(batches[s], _solve_answers(drv, batches[s]), lanes[s], cell)
    drv.solve = base
    with patched(ilqr, "make_batched_mpc_solver", early_exit_factory(ilqr.make_batched_mpc_solver)):
        bad = Driver(cell.cell, cell.config, cell.mix, 0, device)
    for s in seeds[:fault_seeds] if want("early_exit") else ():
        out["early_exit"][s] = solve_stats(batches[s], _solve_answers(bad, batches[s]), lanes[s], cell)
    with patched(ilqr_batched.BatchedSolver, "iteration", unchanged_iteration):
        bad = Driver(cell.cell, cell.config, cell.mix, 0, device)
        for s in seeds[:fault_seeds] if want("unchanged") else ():
            out["unchanged"][s] = solve_stats(batches[s], _solve_answers(bad, batches[s]), lanes[s], cell)
    return out


# ------------------------------------------------------------------ flight cells
def flight_readings(name: str, seeds, fault_seeds, device, overrides=None) -> dict:
    from flightbench.reference import flight_check
    from learningagileflight_se3_torch.sim import closed_loop

    cell = _cell(name, overrides)
    Driver = cell.driver().Driver
    steps = cell.mix["steps"]

    def fly(drv, s, sim=None):
        drv.seed = s
        return flight_check.numbers(cell.config, cell.cell, [drv._fly(sim or drv.sim, 0, steps)], device)

    out = {"sound": {}, "control": {}, "port_tf32": {}, "unchanged": {}, "half": {}, "altered": {}}
    drv = Driver(cell.cell, cell.config, cell.mix, 0, device)
    for s in seeds:
        drv.seed = s
        flight = drv._fly(drv.sim, 0, steps)
        out["sound"][s] = flight_check.numbers(cell.config, cell.cell, [flight], device)
        out["control"][s] = flight_check.numbers(cell.config, cell.cell, [flight], device, control=True)
    half = half_sim(drv.sim)
    for s in seeds[:fault_seeds]:
        out["half"][s] = fly(drv, s, half)
    drv.sim = None
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf = Driver(cell.cell, cell.config, cell.mix, 0, device)
            for s in seeds[:fault_seeds]:
                out["port_tf32"][s] = fly(tf, s)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    alt = Driver(cell.cell, cell.config, cell.mix, 0, device)
    with torch.no_grad():
        alt.model2.layers[-1].bias.add_(0.05)
    alt.sim = alt._make(steps)
    for s in seeds[:fault_seeds]:
        out["altered"][s] = fly(alt, s)
    with patched(closed_loop, "euler_step_renorm", unchanged_plant):
        bad = Driver(cell.cell, cell.config, cell.mix, 0, device)
        for s in seeds[:fault_seeds]:
            out["unchanged"][s] = fly(bad, s)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--fault-seeds", type=int, default=3, help="how many of the seeds the faults run on")
    p.add_argument("--out", default=None)
    p.add_argument("--kinds", default=None, help="comma-separated kinds of a solve cell's readings (default: all)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in a.seeds.split(",")]
    cell = _cell(a.workload)
    fn = solve_readings if cell.cell["driver"] == "solve" else flight_readings
    t = time.perf_counter()
    kw = {"kinds": tuple(a.kinds.split(","))} if a.kinds else {}
    out = fn(a.workload, seeds, a.fault_seeds, "cuda", **kw)
    print(f"readings took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    for kind, per_seed in out.items():
        if kind == "device":
            continue
        keys = sorted({k for v in per_seed.values() for k in v})
        for k in keys:
            vals = [v[k] for v in per_seed.values()]
            if vals:
                print(f"{kind:10s} {k:20s} min {min(vals):.4g} max {max(vals):.4g} n {len(vals)}")
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
