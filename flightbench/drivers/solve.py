"""Batched MPC solves in a closed loop of one caller.

Entry: the port's `solver.ilqr.make_batched_mpc_solver(params, weights,
cfg)(x0, u_last, goal, tra_pos, tra_ang, t)`, at the cell's solver settings
over the configuration's model, bounds and cost.  The mix's distinct
batches are drawn at set-up and cycled through the window; each batch's
controls, costs, status, iterations and line-search trips are fetched to
the host before the next batch is sent.

Set-up solves two batches: the first captures the solve's graph for this
batch size, the second replays it.  The traced slice, after the window,
solves `cell["trace"]["batches"]` batches the same way under the profiler.
The check judges one answer a distinct batch, its pass through the window
drawn from the seed: every lane's cost, and a sample of lanes drawn from
the seed against the reference's own solver.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flightbench import traffic, tracing, yardstick
from flightbench.reference import solve_check


class Driver:
    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        self.cell, self.config, self.mix, self.seed = cell, config, mix, seed
        self.device = torch.device(device)
        self.cfg = SolverConfig(horizon=config["horizon"], dt=config["dt"], **config["bounds"], **cell["solver"])
        self.solve = make_batched_mpc_solver(QuadParams(**config["quad"]), CostWeights(**config["cost"]), self.cfg)
        self.counters = {"B": mix["batch"], "H": config["horizon"]}
        self._pinned = None

    # ------------------------------------------------------------ helpers
    def _fetch(self, sol) -> tuple:
        """(U, J, status, iterations, trips) on the host: copies queued
        behind the solve, then one wait for the stream."""
        fields = (sol.control_traj, sol.cost, sol.status, sol.iterations, sol.ls_evals)
        if self.device.type != "cuda":
            return tuple(f.clone() for f in fields)
        if self._pinned is None:
            self._pinned = tuple(torch.empty(f.shape, dtype=f.dtype, pin_memory=True) for f in fields)
        for dst, src in zip(self._pinned, fields):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._pinned

    def _launches(self) -> dict:
        from learningagileflight_se3_torch.ops import riccati_fused, rollout
        from learningagileflight_se3_torch.utils import graphs

        graphs.settle()
        return {"K1": rollout.launches, "K2": riccati_fused.launches, "host_reads": graphs.host_reads}

    # ------------------------------------------------------------ the run
    def setup(self):
        split = self.counters["setup_split"] = {}
        t = time.perf_counter()
        if self.device.type == "cuda":
            from learningagileflight_se3_torch.ops import build

            build.library(), build.graph_library()  # nvcc at a checkout's first run, else a load
        split["kernel_libraries_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.problems = traffic.solve_batches(self.mix, self.config, self.seed, self.device)
        self._fetch(self.solve(*self.problems[0]))
        split["inputs_and_first_solve_s"] = time.perf_counter() - t
        split["captures_s"] = getattr(self.solve, "capture_seconds", None)
        t = time.perf_counter()
        for p in self.problems[1:2]:
            self._fetch(self.solve(*p))
        split["second_solve_s"] = time.perf_counter() - t
        # the pass through the window whose answer the check judges, per distinct batch
        rng = np.random.default_rng([int(self.seed) % 2**64, 7])
        self.pick = rng.integers(0, self.mix["judged_passes"], size=len(self.problems)).tolist()
        self.answers = [None] * len(self.problems)

    def window(self, seconds: float) -> dict:
        D, B, H = len(self.problems), self.mix["batch"], self.config["horizon"]
        c0 = self._launches()
        flops, n = 0.0, 0
        t0 = time.perf_counter()
        while True:
            d = n % D
            U, J, st, it, ls = self._fetch(self.solve(*self.problems[d]))
            flops += H * (yardstick.K2_FLOPS * float(it.sum()) + yardstick.K1_FLOPS * B * (float(ls) + 1.0))
            if n // D <= self.pick[d]:  # the picked pass, or the last before a short window closed
                self.answers[d] = (U.clone(), J.clone(), st.clone())
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        c1 = self._launches()
        self.counters.update(batches=n, window_s=elapsed, flops=flops,
                             host_reads=c1["host_reads"] - c0["host_reads"],
                             K1=c1["K1"] - c0["K1"], K2=c1["K2"] - c0["K2"])
        return {"elapsed": elapsed, "attempted": n * B, "failed": 0,
                "metrics": {"solves_per_s": n * B / elapsed}}

    def traced(self):
        box = []
        c0 = self._launches()
        with tracing.session(box):
            for i in range(self.cell["trace"]["batches"]):
                self._fetch(self.solve(*self.problems[i % len(self.problems)]))
        c1 = self._launches()
        self.counters.update(slice_K1=c1["K1"] - c0["K1"], slice_K2=c1["K2"] - c0["K2"])
        return box[0]

    def check(self) -> list:
        """The reference's numbers over the judged answers, each with its limit."""
        self.solve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        check = self.cell["check"]
        lanes = solve_check.sample(self.seed, len(self.problems), self.mix["batch"], check["sample"])
        values = solve_check.numbers(self.problems, self.answers, self.config, lanes, check)
        limits = self.cell["check"]["limits"]
        return [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]
