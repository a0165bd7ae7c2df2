"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Builds the hand-written kernels from learningagileflight_se3_torch/csrc/,
holds each against its plain PyTorch version on the card, drives the
batched solver at the bench.py operating point and the 10 Hz deployment
tick, and fails (non-zero exit, no result line) if any phase fails or if
there is no CUDA device.  Imports nothing of JAX.

Phases, each printing its numbers on lines of its own:
  1 device   the nvidia-smi name / power limit, torch and CUDA versions, nvcc
  2 build    nvcc build time and each kernel's ptxas registers / stack
  3 kernels  K1 and K2 against their plain versions at H=50, B=2048 (f64 and
             f32) and each one's time beside the plain version's (CUDA
             events, median of 20)
  4 solve    B=2048, H=50, f32 at the bench.py config: solves/s, iterations,
             line-search trips, status histogram, quality against a golden run
  5 paths    kernel path (CUDA) against plain path (CPU) at H=20, B=256
  6 tick     the replay contract through ExternalSimController on CUDA (f64
             and f32), then the deployed budget's per-tick latency

The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_TIMED = 20
# the kernels' test inputs are the solver's trajectories after this many DDP
# iterations: past the first iterations, where every backward sweep fails
# and the gains are NaN, and before the regularisation has fallen so far that
# the f32 gains are ill-conditioned
INPUT_ITERS = 10


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n=N_TIMED):
    """Median over n runs of fn's device time (CUDA events), after a warm-up."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(a, b):
    """max |a-b| / (|b| + 1e-2) over entries finite in both (the measure of
    tests/test_pallas.py::TestFusedRiccatiKernel), and whether the NaN
    patterns agree."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    err = float(np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2), initial=0.0))
    return err, bool((np.isnan(a) == np.isnan(b)).all())


def max_abs(a, b):
    """max |a-b| over entries finite in both."""
    a, b = a.double().cpu(), b.double().cpu()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0


class Smoke:
    def __init__(self):
        self.failures = []
        self.kernels = {}

    def check(self, ok, what):
        if not ok:
            self.failures.append(what)
            log(f"FAIL: {what}")
        return ok

    def run(self, name, fn):
        log(f"== phase {name}")
        try:
            fn()
        except Exception:  # every phase runs; any failure fails the run
            self.failures.append(f"phase {name} raised")
            log(f"FAIL: phase {name} raised\n{traceback.format_exc()}")

    # ------------------------------------------------------------ 1 device
    def device(self):
        self.smi = nvidia_smi_line()
        log(f"device: {self.smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        from learningagileflight_se3_torch.ops import build

        log(f"nvcc: {build.find_nvcc()} (PATH nvcc: {shutil.which('nvcc')})")

    # ------------------------------------------------------------- 2 build
    def build(self):
        from learningagileflight_se3_torch.ops import build

        t0 = time.perf_counter()
        lib = build.library()
        log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> "
            f"{os.path.relpath(lib.path, REPO)}")
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "stack frame" in line:
                log(f"ptxas: {line.strip()}")

    # ----------------------------------------------------------- 3 kernels
    def kernels_vs_plain(self):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.ops import riccati_fused, rollout
        from learningagileflight_se3_torch.ops.inputs import main_path_inputs

        H, B = 50, 2048
        P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
        t0 = time.perf_counter()
        k1_64, k2_64 = main_path_inputs(H, B, device="cuda", iters=INPUT_ITERS)
        torch.cuda.synchronize()
        log(f"inputs: bench.py scenarios after {INPUT_ITERS} DDP iterations (f64), "
            f"{time.perf_counter() - t0:.2f} s")
        for dtype in (torch.float64, torch.float32):
            name = "f64" if dtype == torch.float64 else "f32"
            # K1, on the lanes whose plain cost is sane (|J| < 1e12): the
            # others are rollouts that blew up, which the line search rejects
            args = [a.to(dtype) for a in k1_64]
            out = rollout.rollout_forward(*args, P, W, C)
            torch.cuda.synchronize()
            ref = rollout.rollout_forward_plain(*args, P, W, C)
            sane = torch.isfinite(ref[2]) & (ref[2].abs() < 1e12)
            log(f"K1 {name}: {int(sane.sum())} of {B} lanes sane")
            self.check(bool(sane.float().mean() >= 0.95), f"K1 {name}: fewer than 95% sane lanes")
            out_s = [a[..., sane] for a in out]
            ref_s = [b[..., sane] for b in ref]
            errs = [max_abs(a, b) for a, b in zip(out_s, ref_s)]
            if dtype == torch.float64:
                rel = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) for a, b in zip(out_s, ref_s))
                self.check(rel <= 1e-9, f"K1 f64 relative error {rel:.3e} > 1e-9")
                log(f"K1 {name}: max rel err {rel:.3e} (gate 1e-9); max abs err Zn/Un/cost {errs}")
            else:
                (Zn, Un, c), (rZ, rU, rc) = out_s, ref_s
                ok = (torch.allclose(Un, rU, rtol=1e-4, atol=2e-5)
                      and torch.allclose(Zn, rZ, rtol=1e-4, atol=2e-4)
                      and torch.allclose(c, rc, rtol=1e-4, atol=1e-2))
                self.check(ok, "K1 f32 outside Un atol 2e-5 / Zn atol 2e-4 / cost rtol 1e-4")
                log(f"K1 {name}: max abs err Zn/Un/cost {errs} (gates Un 2e-5, Zn 2e-4, cost rtol 1e-4)")
                k_ms = median_ms(lambda: rollout.rollout_forward(*args, P, W, C))
                p_ms = median_ms(lambda: rollout.rollout_forward_plain(*args, P, W, C))
                log(f"K1 f32 time: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (H={H}, B={B}, median of {N_TIMED})")
                self.kernels["K1"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms)
            # K2
            args = [a.to(dtype) for a in k2_64]
            out = riccati_fused.riccati_backward(*args, P, W, C)
            torch.cuda.synchronize()
            ref = riccati_fused.riccati_backward_plain(*args, P, W, C)
            tols = (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
                    else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
            parts, errs = [], []
            for nm, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
                if nm == "fail":
                    same = bool((a == b).all())
                    self.check(same, f"K2 {name} fail pattern differs")
                    parts.append(f"fail equal {same} ({int(b.sum())} lanes)")
                    continue
                e, same_nan = rel_err(a, b)
                errs.append(max_abs(a, b))
                self.check(same_nan, f"K2 {name} {nm} NaN pattern differs")
                self.check(e < tols[nm], f"K2 {name} {nm} rel err {e:.3e} >= {tols[nm]}")
                parts.append(f"{nm} {e:.3e}")
            log(f"K2 {name}: rel err " + ", ".join(parts) + f"; max abs err {max(errs):.3e}")
            if dtype == torch.float32:
                k_ms = median_ms(lambda: riccati_fused.riccati_backward(*args, P, W, C))
                p_ms = median_ms(lambda: riccati_fused.riccati_backward_plain(*args, P, W, C))
                log(f"K2 f32 time: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (H={H}, B={B}, median of {N_TIMED})")
                self.kernels["K2"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms)
            else:
                k_ms = median_ms(lambda: riccati_fused.riccati_backward(*args, P, W, C), n=5)
                log(f"K2 f64 time: kernel {k_ms:.4f} ms (median of 5)")

    # ------------------------------------------------------------- 4 solve
    def _bench_args(self, seed, B, device, generator_device="cuda"):
        from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem

        g = torch.Generator(device=generator_device).manual_seed(seed)
        scen = sample_scenarios(g, B).to(device)
        probs = scenario_to_problem(scen)
        x0 = probs["x0"]
        zeros = torch.zeros((B, 1), dtype=scen.dtype, device=device)
        tra_ang = torch.cat([zeros, scen[:, 8:9] * 0.5, zeros], dim=1)
        t = torch.clamp(torch.linalg.vector_norm(x0[:, 0:3], dim=1) / 4.0, 2.0, 4.0)
        return (x0, torch.zeros((B, 4), dtype=scen.dtype, device=device), probs["goal_pos"],
                torch.zeros((B, 3), dtype=scen.dtype, device=device), tra_ang, t)

    def solve(self):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.ops import riccati_fused, rollout
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        B = 2048
        cfg = SolverConfig(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4,
                           ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)
        solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
        warm = solve(*self._bench_args(0, B, "cuda"))
        torch.cuda.synchronize()
        reps = [self._bench_args(100 + i, B, "cuda") for i in range(3)]
        plain0 = (rollout.plain_calls, riccati_fused.plain_calls)
        rollout.launches = riccati_fused.launches = 0
        times, sols = [], []
        for a in reps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols.append(solve(*a))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = (rollout.launches, riccati_fused.launches)
        self.check(launches[0] > 0 and launches[1] > 0, f"phase 4 kernel launches {launches}")
        self.check((rollout.plain_calls, riccati_fused.plain_calls) == plain0,
                   "phase 4 moved a plain-version counter")
        s = sols[0]
        hist = torch.bincount(s.status.long(), minlength=5).tolist()
        log(f"solve: B={B} H=50 f32; rep times {[round(x, 4) for x in times]} s; "
            f"{B / min(times):.1f} solves/s (synced, best of 3); first call {warm.iterations.float().mean().item():.1f} iters")
        log(f"solve: mean iters {s.iterations.float().mean().item():.2f} max {int(s.iterations.max())}; "
            f"line-search trips {int(s.ls_evals)}; status histogram {hist}; "
            f"converged_frac {s.converged.float().mean().item():.4f}")
        log(f"solve: launches in the 3 timed reps K1 {launches[0]} K2 {launches[1]}; "
            f"plain calls unchanged {(rollout.plain_calls, riccati_fused.plain_calls) == plain0}")
        golden = make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(
            horizon=50, max_iters=150, tol=1e-4, gtol=3e-4, ls_adaptive=False, ls_max_trips=14))
        t0 = time.perf_counter()
        g = golden(*reps[0])
        torch.cuda.synchronize()
        Jg, Jb = g.cost.double().cpu().numpy(), s.cost.double().cpu().numpy()
        excess = (Jb - Jg) / np.maximum(np.abs(Jg), 1e-6)
        log(f"solve: golden (150 iters, full ladder) {time.perf_counter() - t0:.2f} s, "
            f"converged {g.converged.float().mean().item():.4f}; frac_within_1pct {(excess < 0.01).mean():.4f} "
            f"frac_within_1e3 {(excess < 1e-3).mean():.4f} median excess {np.median(excess):.3e} "
            f"q90 {np.percentile(excess, 90):.3e}")
        self.check(bool(np.isfinite(Jb).all()) and s.control_traj.shape == (B, 50, 4),
                   "phase 4 solution not finite or misshapen")

    # ------------------------------------------------------------- 5 paths
    def paths(self):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        B = 256
        cfg = SolverConfig(horizon=20, max_iters=60, tol=1e-4, gtol=3e-4)
        solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
        args = self._bench_args(7, B, "cpu", generator_device="cpu")
        t0 = time.perf_counter()
        ks = solve(*[a.cuda() for a in args])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ps = solve(*args)
        t2 = time.perf_counter()
        conv_k, conv_p = ks.converged.cpu().numpy(), ps.converged.numpy()
        both = conv_k & conv_p
        Jk, Jp = ks.cost.double().cpu().numpy(), ps.cost.double().numpy()
        cost_rel = np.abs(Jk - Jp) / np.maximum(np.abs(Jp), 1.0)
        mae = np.abs(ks.control_traj.double().cpu().numpy() - ps.control_traj.double().numpy()).mean(axis=(1, 2))
        both_frac = float(both.mean())
        med_rel = float(np.median(cost_rel[both])) if both.any() else float("inf")
        med_mae = float(np.median(mae[both])) if both.any() else float("inf")
        same_basin = float((cost_rel[both] < 1e-4).mean()) if both.any() else 0.0
        q90 = float(np.percentile(cost_rel[both], 90)) if both.any() else float("inf")
        tail = cost_rel > 1e-4
        unexplained = int((tail & ~(mae > 1e-2) & both).sum())
        log(f"paths: kernel {t1 - t0:.2f} s (CUDA f32), plain {t2 - t1:.2f} s (CPU f32); "
            f"both_converged {both_frac:.4f} median cost rel {med_rel:.3e} median control MAE {med_mae:.3e} "
            f"same_basin {same_basin:.4f} q90 cost rel {q90:.3e}; tail {int(tail.sum())} lanes: "
            f"basin flips {int((tail & (mae > 1e-2)).sum())}, not both converged {int((tail & ~both).sum())}, "
            f"unexplained {unexplained}")
        self.check(both_frac >= 0.5 and med_rel < 1e-5 and med_mae < 1e-4 and same_basin >= 0.85
                   and unexplained == 0, "phase 5 kernel path disagrees with the plain path")

    # -------------------------------------------------------------- 6 tick
    def _replay(self, dtype, cfg, accel, tol):
        from learningagileflight_se3_torch.config import Variant
        from learningagileflight_se3_torch.sim.external_controller import ExternalSimController
        from learningagileflight_se3_torch.utils.weights import load_dnn2

        z = self.contract
        moves, V = z["gate_moves"], z["gate_vel"]
        ctrl = ExternalSimController(
            load_dnn2(), final_point=z["final_point"],
            gate_motion=lambda i: (moves[min(i, len(moves) - 1)], V[min(i, len(moves) - 1)]),
            w_rot=float(z["w_rot"]), origin=z["origin"], variant=Variant.PYBULLET,
            solver_cfg=cfg, fixed_point_tol=tol, fixed_point_accel=accel,
            device="cuda", dtype=dtype,
        )
        acts, ts, lat = [], [], []
        for k in range(len(z["tick_steps"])):
            obs = z["observations"][k]
            t0 = time.perf_counter()
            a, t = ctrl.compute_control(step=int(z["tick_steps"][k]), cur_pos=obs[0:3],
                                        cur_quat_xyzw=obs[3:7], cur_vel=obs[10:13],
                                        cur_euler_rates=obs[13:16], cur_rpy=obs[7:10])
            lat.append(time.perf_counter() - t0)  # ends in the tick's host fetch
            acts.append(a)
            ts.append(t)
        return np.asarray(acts), np.asarray(ts), np.asarray(lat)

    def tick(self):
        from learningagileflight_se3_torch.config import SolverConfig
        from learningagileflight_se3_torch.ops import riccati_fused, rollout

        self.contract = z = np.load(os.path.join(REPO, "artifacts", "replay_contract.npz"))
        u_ub, tol = float(z["solver_u_ub"]), float(z["fixed_point_tol"])
        c_cfg = SolverConfig(horizon=int(z["solver_horizon"]), max_iters=int(z["solver_max_iters"]), u_ub=u_ub)
        plain0 = (rollout.plain_calls, riccati_fused.plain_calls)
        rollout.launches = riccati_fused.launches = 0
        acts, ts, _ = self._replay(torch.float64, c_cfg, "reference", tol)
        da, dt_ = np.abs(acts - z["actions"]).max(), np.abs(ts - z["tra_times"]).max()
        self.check(da <= 1e-4 and dt_ < 1e-6, f"replay contract f64: wrench {da:.3e}, t {dt_:.3e}")
        log(f"tick: replay contract f64 on CUDA: max wrench dev {da:.3e} (atol 1e-4), "
            f"max t dev {dt_:.3e} (< 1e-6); launches K1 {rollout.launches} K2 {riccati_fused.launches}")
        acts, ts, _ = self._replay(torch.float32, c_cfg, "reference", tol)
        log(f"tick: replay contract f32 on CUDA: max wrench dev {np.abs(acts - z['actions']).max():.3e}, "
            f"max t dev {np.abs(ts - z['tra_times']).max():.3e}")
        d_cfg = SolverConfig(horizon=50, max_iters=30, u_ub=u_ub, tol=1e-4, gtol=3e-4,
                             ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)
        self._replay(torch.float32, d_cfg, "secant", tol)  # warm-up pass
        rollout.launches = riccati_fused.launches = 0
        acts, ts, lat = self._replay(torch.float32, d_cfg, "secant", tol)
        self.main_path_launches = (rollout.launches, riccati_fused.launches)
        self.check(min(self.main_path_launches) > 0, f"phase 6 kernel launches {self.main_path_launches}")
        self.check((rollout.plain_calls, riccati_fused.plain_calls) == plain0,
                   "phase 6 moved a plain-version counter")
        self.check(bool(np.isfinite(acts).all() and np.isfinite(ts).all()), "phase 6 non-finite tick output")
        ms = lat * 1e3
        log(f"tick: deployed budget (PYBULLET, H=50, max_iters=30, secant, f32): per-tick ms "
            f"{[round(x, 3) for x in ms]}; p50 {np.percentile(ms, 50):.3f} ms p90 {np.percentile(ms, 90):.3f} ms; "
            f"launches K1 {self.main_path_launches[0]} K2 {self.main_path_launches[1]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import learningagileflight_se3_torch  # noqa: F401  (fails outside the repo)

    s = Smoke()
    s.run("1 device", s.device)
    s.run("2 build", s.build)
    s.run("3 kernels", s.kernels_vs_plain)
    s.run("4 solve", s.solve)
    s.run("5 paths", s.paths)
    s.run("6 tick", s.tick)
    if s.failures or len(s.kernels) != 2:
        log(f"chip_smoke FAILED: {s.failures}")
        return 1
    src = "learningagileflight_se3_torch/csrc/"
    rows = [
        dict(name="K1 rollout_forward", route="cuda", source=src + "rollout.cu",
             replaces="learningagileflight_se3_tpu/ops/rollout_pallas.py:167",
             launches=s.main_path_launches[0], **s.kernels["K1"]),
        dict(name="K2 riccati_backward_fused", route="cuda", source=src + "riccati_fused.cu",
             replaces="learningagileflight_se3_tpu/ops/riccati_fused.py:446",
             launches=s.main_path_launches[1], **s.kernels["K2"]),
    ]
    print(json.dumps({"kernels": rows}))
    print(s.smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
