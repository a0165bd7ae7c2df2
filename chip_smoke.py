"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Builds the hand-written kernels from learningagileflight_se3_torch/csrc/,
holds each against its plain PyTorch version on the card, drives the
batched solver at the bench.py operating point, the 10 Hz deployment tick
and stage-2 RL training of DNN1, and fails (non-zero exit, no result line)
if any phase fails or if there is no CUDA device.  Imports nothing of JAX.

Phases, each printing its numbers on lines of its own:
  1 device   the nvidia-smi name / power limit, torch and CUDA versions, nvcc
  2 build    nvcc build time, each kernel's ptxas registers / shared memory
             / stack, K1's gain ring and K3's ring and working set (dynamic
             shared memory)
  3 kernels  K1 and K2 against their plain versions at H=50 and B=2048 (the
             bench.py point), 256 (the analytic RL step) and 1 (the tick), f64
             and f32; each f32 time (CUDA events, the card's time alone)
             beside its bound at that shape, the time of the one-thread-per-
             scenario kernel it replaced, and the plain version's
  4 solve    B=2048, H=50, f32 at the bench.py config: solves/s, iterations,
             line-search trips, status histogram, quality against a golden run
  5 paths    kernel path (CUDA) against plain path (CPU) at H=20, B=256
  6 tick     the replay contract through ExternalSimController on CUDA (f64
             and f32), then the deployed budget's per-tick latency
  7 K3       the unfused backward sweep against its plain version (f64, f32)
             and against K2 on the same trajectory (f64) at phase 3's shapes
             and inputs (H=50, B=2048, 256, 1), with the times of K3 (the
             card's alone), its bound, its plain version and K2 (f32)
  8 train    stage-2 RL of DNN1 at the --full settings (B=256, H=50, f32):
             nn_pre / nn_deep rewards, K1 and K2 against their plain
             versions on the inputs of the analytic (B=256) and the fd
             (B=2,304) training solves (f64 and f32, phase 3's gates), 3
             analytic epochs from nn_pre, one fd step, resume against the
             uninterrupted run, the step's time split, and both learning
             signals on CUDA against the CPU

The last three lines are the kernels JSON (each row's `launches` is the
count of phase 4's solve, the main path, `launches_by_path` each path's
own; `bound_ms` the least time the card could take at B=2048, `library_ms`
null: no single PyTorch call computes these functions), the nvidia-smi line
and {"ok": true, "device": {...}}.  Every time is printed with the card's
nvidia-smi name and power limit.

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
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): a
# kernel's bound is the larger of the bytes it must move over the memory
# rate and its operations over the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operations per scenario and step, counted from the kernels' code (a
# multiply and an add are two).  K1: z - z_ref 17, the gains 144, the stage
# cost 150, the Euler step 110.  K2: the Vzz update 5.5k, M = Vzz A and
# Qzz = A^T M 1.3k each, the value recursion 0.9k, the K solve 0.8k, B^T Vzz
# 0.6k, Quz and Quu 0.5k, the rest 1.0k, and 3 boxQP iterations of 350,
# about what the solver's trajectories need of the 6 (the later ones repeat
# the iterate, and the kernels stop there).  K3: K2's, with dense products in place of the
# block-sparse ones (M and Qzz 9.8k each, B^T Vzz and Quz 2.3k each).
K1_FLOPS, K2_FLOPS, K3_FLOPS = 420, 13_000, 35_600
# Times of the one-thread-per-scenario kernels that K1 and K2 replaced, f32,
# H=50 (PERF.md section 6: CUDA events around the wrapper, the host's
# enqueue included; B=1 from a torch.profiler trace of the tick)
ONE_THREAD_MS = {("K1", 2048): 0.2985, ("K2", 2048): 2.0112, ("K1", 256): 0.1446,
                 ("K2", 256): 1.9627, ("K1", 1): 0.15, ("K2", 1): 1.82}
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


def median_ms(fn, n=N_TIMED, card_only=False):
    """Median over n runs of fn's time on CUDA events, after a warm-up.  With
    card_only the card first spins for about a millisecond, so that the
    host's enqueue of fn (the wrapper's checks and allocations) overlaps the
    spin and the events time the card's work alone."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if card_only:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(inputs, outputs, flops):
    """(bound_ms, bound_by): the least time the card could take to read every
    input once, write every output once (in the inputs' dtype) and do
    `flops` f32 operations."""
    size = inputs[0].element_size()
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + sum(t.numel() * size for t in outputs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def reset_launches():
    """Set the launch count of every kernel wrapper to 0."""
    from learningagileflight_se3_torch.ops import riccati_fused, riccati_unfused, rollout

    rollout.launches = riccati_fused.launches = riccati_unfused.launches = 0


def read_launches():
    """{"K1": n, "K2": n, "K3": n}: each kernel wrapper's launch count."""
    from learningagileflight_se3_torch.ops import riccati_fused, riccati_unfused, rollout

    return dict(K1=rollout.launches, K2=riccati_fused.launches, K3=riccati_unfused.launches)


def read_plain_calls():
    """(K1, K2) plain-version call counts."""
    from learningagileflight_se3_torch.ops import riccati_fused, rollout

    return rollout.plain_calls, riccati_fused.plain_calls


class Smoke:
    def __init__(self):
        self.failures = []
        self.smi = "nvidia-smi not read"
        self.kernels = {}
        self.path_launches = {}  # path -> read_launches() over that path's run
        self.k2_inputs = {}      # B -> phase 3's K2 inputs (f64)

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
        from learningagileflight_se3_torch.ops import build, riccati_unfused, rollout

        t0 = time.perf_counter()
        lib = build.library()
        log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> "
            f"{os.path.relpath(lib.path, REPO)}")
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "stack frame" in line:
                log(f"ptxas: {line.strip()}")
        log(f"K1 gain ring (dynamic shared memory per block): f32 {rollout.ring_bytes(torch.float32)} B, "
            f"f64 {rollout.ring_bytes(torch.float64)} B")
        log(f"K3 ring and working set (dynamic shared memory per block): f32 "
            f"{riccati_unfused.smem_bytes(torch.float32)} B, f64 {riccati_unfused.smem_bytes(torch.float64)} B")

    # ----------------------------------------------------------- 3 kernels
    def kernels_vs_plain(self):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.ops import riccati_fused, rollout
        from learningagileflight_se3_torch.ops.inputs import main_path_inputs

        H = 50
        P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
        # the bench.py point, the analytic RL step, the tick
        for B in (2048, 256, 1):
            t0 = time.perf_counter()
            k1_64, k2_64 = main_path_inputs(H, B, device="cuda", iters=INPUT_ITERS)
            self.k2_inputs[B] = k2_64  # phase 7 holds K3 against K2 on them
            torch.cuda.synchronize()
            log(f"inputs: H={H}, B={B}: bench.py scenarios after {INPUT_ITERS} DDP iterations (f64), "
                f"{time.perf_counter() - t0:.2f} s")
            for dtype in (torch.float64, torch.float32):
                name = f"{'f64' if dtype == torch.float64 else 'f32'}, B={B}"
                a1 = [a.to(dtype) for a in k1_64]
                out1 = rollout.rollout_forward(*a1, P, W, C)
                torch.cuda.synchronize()
                errs1 = self.check_rollout(f"K1 {name}", out1, rollout.rollout_forward_plain(*a1, P, W, C),
                                           dtype)
                a2 = [a.to(dtype) for a in k2_64]
                out2 = riccati_fused.riccati_backward(*a2, P, W, C)
                torch.cuda.synchronize()
                errs2 = self.check_sweep(f"K2 {name}", out2, riccati_fused.riccati_backward_plain(*a2, P, W, C),
                                         dtype)
                if dtype == torch.float64:
                    continue
                runs = {"K1": (lambda: rollout.rollout_forward(*a1, P, W, C),
                               lambda: rollout.rollout_forward_plain(*a1, P, W, C),
                               bound(a1, out1, K1_FLOPS * B * H), errs1),
                        "K2": (lambda: riccati_fused.riccati_backward(*a2, P, W, C),
                               lambda: riccati_fused.riccati_backward_plain(*a2, P, W, C),
                               bound(a2, out2, K2_FLOPS * B * H), errs2)}
                for k, (kernel, plain, (b_ms, b_by), errs) in runs.items():
                    k_ms = median_ms(kernel, card_only=True)
                    p_ms = median_ms(plain, n=5)
                    log(f"{k} f32 time, H={H}, B={B}: kernel {k_ms:.4f} ms (the card's time, median of "
                        f"{N_TIMED}); bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms:.1%} of it reached; "
                        f"one-thread kernel {ONE_THREAD_MS[k, B]} ms; plain {p_ms:.4f} ms (median of 5) [{self.smi}]")
                    if B == 2048:
                        self.kernels[k] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                               bound_by=b_by, library_ms=None)

    def check_rollout(self, what, out, ref, dtype):
        """Hold K1's outputs (Zn, Un, cost) against its plain version's, on
        the lanes whose plain cost is sane (|J| < 1e12; the others are
        rollouts that blew up, which the line search rejects), at least 95%
        of them: relative error 1e-9 in f64; Un atol 2e-5, Zn atol 2e-4 and
        cost rtol 1e-4 in f32.  Returns the max abs errors."""
        sane = torch.isfinite(ref[2]) & (ref[2].abs() < 1e12)
        n_sane = f"{int(sane.sum())} of {sane.numel()} lanes sane"
        self.check(bool(sane.float().mean() >= 0.95), f"{what}: {n_sane}, fewer than 95%")
        out_s = [a[..., sane] for a in out]
        ref_s = [b[..., sane] for b in ref]
        errs = [max_abs(a, b) for a, b in zip(out_s, ref_s)]
        if dtype == torch.float64:
            rel = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) for a, b in zip(out_s, ref_s))
            self.check(rel <= 1e-9, f"{what} relative error {rel:.3e} > 1e-9")
            log(f"{what}: {n_sane}; max rel err {rel:.3e} (gate 1e-9); max abs err Zn/Un/cost {errs}")
        else:
            (Zn, Un, c), (rZ, rU, rc) = out_s, ref_s
            ok = (torch.allclose(Un, rU, rtol=1e-4, atol=2e-5)
                  and torch.allclose(Zn, rZ, rtol=1e-4, atol=2e-4)
                  and torch.allclose(c, rc, rtol=1e-4, atol=1e-2))
            self.check(ok, f"{what} outside Un atol 2e-5 / Zn atol 2e-4 / cost rtol 1e-4")
            log(f"{what}: {n_sane}; max abs err Zn/Un/cost {errs} (gates Un 2e-5, Zn 2e-4, "
                f"cost rtol 1e-4)")
        return errs

    def check_sweep(self, what, out, ref, dtype):
        """Hold a backward sweep's outputs (kk, KK, dV1, dV2, fail, pg)
        against a reference: relative error (rel_err) under K2's gates, 1e-8
        in f64, kk 5e-3 / KK 8e-3 / dV 1e-3 / pg 1e-4 in f32, and identical
        fail and NaN patterns.  Returns the max abs errors."""
        tols = (dict(kk=1e-8, KK=1e-8, dV1=1e-8, dV2=1e-8, pg=1e-8) if dtype == torch.float64
                else dict(kk=5e-3, KK=8e-3, dV1=1e-3, dV2=1e-3, pg=1e-4))
        parts, errs = [], []
        for nm, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
            if nm == "fail":
                same = bool((a == b).all())
                self.check(same, f"{what} fail pattern differs")
                parts.append(f"fail equal {same} ({int(b.sum())} lanes)")
                continue
            e, same_nan = rel_err(a, b)
            errs.append(max_abs(a, b))
            self.check(same_nan, f"{what} {nm} NaN pattern differs")
            self.check(e < tols[nm], f"{what} {nm} rel err {e:.3e} >= {tols[nm]}")
            parts.append(f"{nm} {e:.3e}")
        log(f"{what}: rel err " + ", ".join(parts) + f"; max abs err {max(errs):.3e}")
        return errs

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
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        B = 2048
        cfg = SolverConfig(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4,
                           ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)
        solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
        warm = solve(*self._bench_args(0, B, "cuda"))
        torch.cuda.synchronize()
        reps = [self._bench_args(100 + i, B, "cuda") for i in range(3)]
        plain0 = read_plain_calls()
        reset_launches()
        times, sols = [], []
        for a in reps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols.append(solve(*a))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        self.path_launches["solve"] = n = read_launches()
        launches = (n["K1"], n["K2"])
        self.check(launches[0] > 0 and launches[1] > 0, f"phase 4 kernel launches {launches}")
        self.check(read_plain_calls() == plain0, "phase 4 moved a plain-version counter")
        s = sols[0]
        hist = torch.bincount(s.status.long(), minlength=5).tolist()
        log(f"solve: B={B} H=50 f32; rep times {[round(x, 4) for x in times]} s; "
            f"{B / min(times):.1f} solves/s (synced, best of 3); first call {warm.iterations.float().mean().item():.1f} "
            f"iters [{self.smi}]")
        log(f"solve: mean iters {s.iterations.float().mean().item():.2f} max {int(s.iterations.max())}; "
            f"line-search trips {int(s.ls_evals)}; status histogram {hist}; "
            f"converged_frac {s.converged.float().mean().item():.4f}")
        log(f"solve: launches in the 3 timed reps K1 {launches[0]} K2 {launches[1]}; "
            f"plain calls unchanged {read_plain_calls() == plain0}")
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
            f"q90 {np.percentile(excess, 90):.3e} [{self.smi}]")
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

        self.contract = z = np.load(os.path.join(REPO, "artifacts", "replay_contract.npz"))
        u_ub, tol = float(z["solver_u_ub"]), float(z["fixed_point_tol"])
        c_cfg = SolverConfig(horizon=int(z["solver_horizon"]), max_iters=int(z["solver_max_iters"]), u_ub=u_ub)
        plain0 = read_plain_calls()
        reset_launches()
        acts, ts, _ = self._replay(torch.float64, c_cfg, "reference", tol)
        n = read_launches()
        da, dt_ = np.abs(acts - z["actions"]).max(), np.abs(ts - z["tra_times"]).max()
        self.check(da <= 1e-4 and dt_ < 1e-6, f"replay contract f64: wrench {da:.3e}, t {dt_:.3e}")
        log(f"tick: replay contract f64 on CUDA: max wrench dev {da:.3e} (atol 1e-4), "
            f"max t dev {dt_:.3e} (< 1e-6); launches K1 {n['K1']} K2 {n['K2']}")
        acts, ts, _ = self._replay(torch.float32, c_cfg, "reference", tol)
        log(f"tick: replay contract f32 on CUDA: max wrench dev {np.abs(acts - z['actions']).max():.3e}, "
            f"max t dev {np.abs(ts - z['tra_times']).max():.3e}")
        d_cfg = SolverConfig(horizon=50, max_iters=30, u_ub=u_ub, tol=1e-4, gtol=3e-4,
                             ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)
        self._replay(torch.float32, d_cfg, "secant", tol)  # warm-up pass
        reset_launches()
        acts, ts, lat = self._replay(torch.float32, d_cfg, "secant", tol)
        self.path_launches["tick"] = n = read_launches()
        self.check(min(n["K1"], n["K2"]) > 0, f"phase 6 kernel launches {n}")
        self.check(read_plain_calls() == plain0, "phase 6 moved a plain-version counter")
        self.check(bool(np.isfinite(acts).all() and np.isfinite(ts).all()), "phase 6 non-finite tick output")
        ms = lat * 1e3
        log(f"tick: deployed budget (PYBULLET, H=50, max_iters=30, secant, f32): per-tick ms "
            f"{[round(float(x), 3) for x in ms]}; p50 {np.percentile(ms, 50):.3f} ms "
            f"p90 {np.percentile(ms, 90):.3f} ms; launches K1 {n['K1']} K2 {n['K2']} [{self.smi}]")


    # ---------------------------------------------------------------- 7 K3
    def k3(self):
        from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
        from learningagileflight_se3_torch.ops import riccati_fused, riccati_unfused

        H = 50
        P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
        kw = dict(dt=C.dt, lb=C.u_lb, ub=C.u_ub)
        riccati_unfused.launches = 0
        for B in (2048, 256, 1):  # phase 3's shapes and inputs
            k2_64 = self.k2_inputs[B]
            derivs_64 = riccati_unfused.derivatives_plain(*k2_64, P, W, C)
            for dtype in (torch.float64, torch.float32):
                name = f"{'f64' if dtype == torch.float64 else 'f32'}, B={B}"
                args = [a.to(dtype) for a in derivs_64]
                out = riccati_unfused.riccati_backward_unfused(*args, P, **kw)
                torch.cuda.synchronize()
                ref = riccati_unfused.riccati_unfused_plain(*args, P, **kw)
                errs = self.check_sweep(f"K3 {name} vs plain", out, ref, dtype)
                if dtype == torch.float64:
                    self.check_sweep(f"K3 {name} vs K2", out, riccati_fused.riccati_backward(*k2_64, P, W, C),
                                     dtype)
                    continue
                k2_args = [a.to(dtype) for a in k2_64]
                k_ms = median_ms(lambda: riccati_unfused.riccati_backward_unfused(*args, P, **kw), card_only=True)
                p_ms = median_ms(lambda: riccati_unfused.riccati_unfused_plain(*args, P, **kw), n=5)
                f_ms = median_ms(lambda: riccati_fused.riccati_backward(*k2_args, P, W, C), card_only=True)
                # of ZU the sweep reads only the rows of its DDP term, the
                # quaternion (6..9) and the controls (17..20)
                read = args[:8] + [args[8][:, 6:10], args[8][:, 17:21]] + args[9:]
                b_ms, b_by = bound(read, out, K3_FLOPS * B * H)
                log(f"K3 f32 time, H={H}, B={B}: kernel {k_ms:.4f} ms (the card's time, median of {N_TIMED}); "
                    f"bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms:.1%} of it reached; plain {p_ms:.4f} ms "
                    f"(median of 5); K2 on the same trajectory {f_ms:.4f} ms [{self.smi}]")
                if B == 2048:
                    self.kernels["K3"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                              bound_by=b_by, library_ms=None)
        self.k3_launches = riccati_unfused.launches

    # ------------------------------------------------------------- 8 train
    def train(self):
        import copy
        import re
        import tempfile

        from learningagileflight_se3_torch.config import (
            CostWeights, QuadParams, RewardConfig, SolverConfig,
        )
        from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
        from learningagileflight_se3_torch.policy import make_fd_gradient_batched, make_rewards_batched
        from learningagileflight_se3_torch.train.rl import make_rl_train_step, run_rl_training
        from learningagileflight_se3_torch.utils.weights import NN_DEEP_DNN1, load_dnn1

        # scripts/train_pipeline.py --full, stage 2, on an accelerator
        P, W, R = QuadParams(), CostWeights(), RewardConfig()
        cfg = SolverConfig(horizon=50, max_iters=45, tol=1e-4, gtol=3e-4, no_progress_iters=10)
        B, EPOCHS, SEED = 256, 400, 0
        dev = torch.device("cuda")
        nn_pre = load_dnn1().to(dev)
        nn_deep = load_dnn1(NN_DEEP_DNN1).to(dev)

        def problem(scen, model):
            probs = scenario_to_problem(scen)
            with torch.no_grad():
                out = model(scen)
            return (probs["x0"], torch.zeros((scen.shape[0], 4), device=scen.device),
                    probs["goal_pos"], probs["gate_pts"], out[:, 0:3], out[:, 3:6], out[:, 6])

        # 1-2: both shipped DNN1s through the analytic forward solve; nn_pre's
        # solve is the training step's forward solve (B=256), and the K1 / K2
        # inputs of one of its DDP iterations are kept
        rewards = make_rewards_batched(P, W, cfg, R)
        scen = sample_scenarios(torch.Generator(device=dev).manual_seed(1234), B)
        with torch.no_grad():
            r_pre, kernel_inputs_analytic = self._capture(lambda: rewards(*problem(scen, nn_pre)))
            r_deep = rewards(*problem(scen, nn_deep))
        m_pre, m_deep = float(r_pre.mean()), float(r_deep.mean())
        log(f"train: mean reward on {B} scenarios: nn_pre {m_pre:.4f}, nn_deep {m_deep:.4f} "
            f"(finite {bool(torch.isfinite(r_pre).all())}, {bool(torch.isfinite(r_deep).all())})")
        self.check(bool(torch.isfinite(r_pre).all() and torch.isfinite(r_deep).all()),
                   "phase 8 nn_pre / nn_deep rewards not finite")
        self.check(m_deep > m_pre, "nn_deep does not score above nn_pre")

        # K1 and K2 against their plain versions at the training shapes: the
        # analytic signal's solve (B=256) and the fd signal's (9 x 256 probe
        # lanes), on the inputs these solves gave the kernels
        fd = make_fd_gradient_batched(P, W, cfg, R)
        _, kernel_inputs_fd = self._capture(lambda: fd(*problem(scen, nn_pre)))
        self._kernels_at_training_shapes("analytic", kernel_inputs_analytic)
        self._kernels_at_training_shapes("fd", kernel_inputs_fd)

        # 3: three analytic epochs of the 400-epoch schedule from nn_pre; the
        # run is cut after epoch 3 by its per-epoch log callback
        class Cut(Exception):
            pass

        def runner(stop_after, record=None):
            t_last = [time.perf_counter()]

            def log_fn(line):
                torch.cuda.synchronize()
                m = re.match(r"rl epoch (\d+)/\d+ mean reward (\S+) valid (\S+)", line)
                if m is None:
                    return
                if record is not None:
                    now = time.perf_counter()
                    n = read_launches()
                    record.append((int(m.group(1)), float(m.group(2)), float(m.group(3)),
                                   now - t_last[0], n["K1"], n["K2"]))
                    t_last[0] = now
                if int(m.group(1)) == stop_after:
                    raise Cut
            return log_fn

        kw = dict(epochs=EPOCHS, batch_size=B, lr=1e-4, params_q=P, weights=W, solver_cfg=cfg,
                  reward_cfg=R, grad_mode="analytic", lr_schedule=True, device=dev)
        model_u = copy.deepcopy(nn_pre)
        p0 = [p.detach().clone() for p in model_u.parameters()]
        record = []
        plain0 = read_plain_calls()
        reset_launches()
        try:
            run_rl_training(SEED, model_u, log_fn=runner(3, record), **kw)
        except Cut:
            pass
        self.path_launches["train"] = n = read_launches()
        launches = (n["K1"], n["K2"])
        for e, mr, vf, sec, l1, l2 in record:
            log(f"train: epoch {e}: mean reward {mr:.4f}, valid rows {vf:.4f}, {sec:.3f} s "
                f"(host, synced); launches so far K1 {l1} K2 {l2}")
        self.check(len(record) == 3 and all(np.isfinite(r[1]) for r in record),
                   "phase 8 epochs missing or non-finite rewards")
        self.check(launches[0] > 0 and launches[1] > 0, f"phase 8 kernel launches {launches}")
        self.check(read_plain_calls() == plain0, "phase 8 moved a plain-version counter")
        params_u = [p.detach() for p in model_u.parameters()]
        moved = max(float((a - b).abs().max()) for a, b in zip(params_u, p0))
        self.check(all(bool(torch.isfinite(p).all()) for p in params_u) and moved > 0,
                   "phase 8 parameters not finite or did not move")
        log(f"train: 3 epochs, launches K1 {launches[0]} K2 {launches[1]}; largest parameter "
            f"move {moved:.3e}")

        # 4: one fd step (9 x 256 = 2,304 probe lanes)
        model_f = copy.deepcopy(nn_pre)
        opt_f = torch.optim.Adam(model_f.parameters(), lr=1e-4)
        step = make_rl_train_step(model_f, opt_f, P, W, cfg, R, grad_mode="fd")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(scen)
        torch.cuda.synchronize()
        log(f"train: fd step (B={B}, {9 * B} probe lanes): {time.perf_counter() - t0:.3f} s, "
            f"mean reward {float(res.mean_reward):.4f}, valid rows {float(res.valid.float().mean()):.4f}")
        self.check(bool(torch.isfinite(res.rewards).all()), "phase 8 fd rewards not finite")

        # 5: cut after the epoch-2 checkpoint, resume, compare epoch 3
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as ck:
            try:
                run_rl_training(SEED, copy.deepcopy(nn_pre), checkpoint_dir=ck, checkpoint_every=2,
                                log_fn=runner(2), **kw)
            except Cut:
                pass
            model_r = copy.deepcopy(nn_pre)
            rec_r = []
            try:
                run_rl_training(SEED, model_r, checkpoint_dir=ck, checkpoint_every=2, resume=True,
                                log_fn=runner(3, rec_r), **kw)
            except Cut:
                pass
        d_param = max(float((a.detach() - b).abs().max())
                      for a, b in zip(model_r.parameters(), params_u))
        d_rew = abs(rec_r[0][1] - record[2][1]) if rec_r else float("inf")
        # the reward's backward scatters through gathers with atomics, so
        # two runs may differ in the last f32 bits
        self.check(len(rec_r) == 1 and d_param <= 1e-6 and d_rew <= 1e-3 * (1 + abs(record[2][1])),
                   f"phase 8 resume differs: params {d_param:.3e}, epoch-3 reward {d_rew:.3e}")
        log(f"train: resumed epoch 3 against the uninterrupted run: max param diff {d_param:.3e} "
            f"(gate 1e-6), mean reward diff {d_rew:.3e}")

        self._train_split(P, W, R, cfg, scen, nn_pre)
        self._signals_cuda_vs_cpu(P, W, R, nn_pre)

    def _capture(self, run, k2_call=INPUT_ITERS):
        """run() with recorders around the batched solver's K1 and K2
        wrappers.  Returns run()'s result and {"K2": the inputs of the
        solve's k2_call-th K2 launch (its last, if it made fewer), "K1": those
        of the first K1 launch after it, a line-search trip}, each as
        (tensors, model args, keyword args).  The recorders launch nothing of
        their own."""
        from learningagileflight_se3_torch.solver import ilqr_batched

        real_k1, real_k2 = ilqr_batched.rollout_forward, ilqr_batched.riccati_backward
        got, n_k2 = {}, [0]

        def k2(*a, **kw):
            n_k2[0] += 1
            if n_k2[0] <= k2_call:
                got["K2"] = ([x.clone() for x in a[:9]], a[9:], kw)
                got.pop("K1", None)
            return real_k2(*a, **kw)

        def k1(*a, **kw):
            if "K2" in got and "K1" not in got:
                got["K1"] = ([x.clone() for x in a[:9]], a[9:], kw)
            return real_k1(*a, **kw)

        ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = k1, k2
        try:
            out = run()
        finally:
            ilqr_batched.rollout_forward, ilqr_batched.riccati_backward = real_k1, real_k2
        return out, got

    def _kernels_at_training_shapes(self, signal, got):
        """K1 and K2 against their plain versions on the inputs one DDP
        iteration of a training solve gave them (see _capture), in f64 and
        f32 under phase 3's gates, and their f32 times beside the plain
        versions' (kernel median of 20, plain of 5)."""
        from learningagileflight_se3_torch.ops import riccati_fused, rollout

        if not self.check("K1" in got and "K2" in got, f"phase 8 {signal}: K1 / K2 inputs not captured"):
            return
        (k1, k1_args, k1_kw), (k2, k2_args, k2_kw) = got["K1"], got["K2"]
        H, _, B = k2[0].shape
        where = f"{signal} solve, H={H}, B={B}"
        for dtype in (torch.float64, torch.float32):
            name = "f64" if dtype == torch.float64 else "f32"
            a1 = [x.to(dtype) for x in k1]
            out = rollout.rollout_forward(*a1, *k1_args, **k1_kw)
            torch.cuda.synchronize()
            self.check_rollout(f"K1 {name} ({where})", out,
                               rollout.rollout_forward_plain(*a1, *k1_args, **k1_kw), dtype)
            a2 = [x.to(dtype) for x in k2]
            out = riccati_fused.riccati_backward(*a2, *k2_args, **k2_kw)
            torch.cuda.synchronize()
            self.check_sweep(f"K2 {name} ({where})", out,
                             riccati_fused.riccati_backward_plain(*a2, *k2_args, **k2_kw), dtype)
        ms = [median_ms(lambda: rollout.rollout_forward(*a1, *k1_args, **k1_kw), card_only=True),
              median_ms(lambda: rollout.rollout_forward_plain(*a1, *k1_args, **k1_kw), n=5),
              median_ms(lambda: riccati_fused.riccati_backward(*a2, *k2_args, **k2_kw), card_only=True),
              median_ms(lambda: riccati_fused.riccati_backward_plain(*a2, *k2_args, **k2_kw), n=5)]
        log(f"f32 time ({where}): K1 kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms; "
            f"K2 kernel {ms[2]:.4f} ms, plain {ms[3]:.4f} ms (kernel: the card's time, median of "
            f"{N_TIMED}; plain: median of 5) [{self.smi}]")

    def _train_split(self, P, W, R, cfg, scen, model):
        """The analytic step's time by part: the forward solve, the VJP
        sweep, and the rollout + reward with its gradient."""
        import dataclasses

        from learningagileflight_se3_torch.dynamics.quadrotor import rollout as roll
        from learningagileflight_se3_torch.geometry.collision import trajectory_reward
        from learningagileflight_se3_torch.models.sampler import scenario_to_problem
        from learningagileflight_se3_torch.solver.diff import make_vjp_batched
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        c = dataclasses.replace(cfg, quantize_t=False)
        probs = scenario_to_problem(scen)
        with torch.no_grad():
            out = model(scen)
        B = scen.shape[0]
        args = (probs["x0"], torch.zeros((B, 4), device=scen.device), probs["goal_pos"],
                out[:, 0:3], out[:, 3:6], out[:, 6])
        solve, vjp = make_batched_mpc_solver(P, W, c), make_vjp_batched(P, W, c)
        times = {}
        for rep in range(2):  # the first pass warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            U = solve(*args).control_traj
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            Ul = U.detach().requires_grad_(True)
            X = roll(args[0], Ul, c.dt, P)
            r, *_ = trajectory_reward(X, probs["gate_pts"], args[2], R, c.horizon)
            (U_bar,) = torch.autograd.grad(r.sum(), Ul)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            vjp(U, *args, U_bar)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            times = dict(solve=t1 - t0, reward=t2 - t1, vjp=t3 - t2)
        log(f"train: analytic step (B={B}, host synced) {sum(times.values()) * 1e3:.1f} ms: " +
            ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items()) + f" [{self.smi}]")

    def _signals_cuda_vs_cpu(self, P, W, R, model):
        """Both learning signals at H=20, B=64: CUDA f32 (the kernels)
        against CPU f32 (the plain versions), on the lanes whose base solve
        converged in both and landed in the same basin, as in phase 5."""
        import copy

        from learningagileflight_se3_torch.config import SolverConfig
        from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
        from learningagileflight_se3_torch.policy import (
            make_analytic_gradient_batched, make_fd_gradient_batched,
        )
        from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

        B = 64
        cfg = SolverConfig(horizon=20, max_iters=45, tol=1e-4, gtol=3e-4, no_progress_iters=10,
                           quantize_t=False)
        scen = sample_scenarios(torch.Generator().manual_seed(77), B)
        model_cpu = copy.deepcopy(model).cpu()
        probs = scenario_to_problem(scen)
        with torch.no_grad():
            out = model_cpu(scen)
        args = [probs["x0"], torch.zeros((B, 4)), probs["goal_pos"], probs["gate_pts"],
                out[:, 0:3], out[:, 3:6], out[:, 6]]
        cuda = lambda a: [x.cuda() for x in a]
        solve = make_batched_mpc_solver(P, W, cfg)
        sk = solve(*cuda([args[i] for i in (0, 1, 2, 4, 5, 6)]))
        sp = solve(*[args[i] for i in (0, 1, 2, 4, 5, 6)])
        Jk, Jp = sk.cost.double().cpu(), sp.cost.double()
        basin = (sk.converged.cpu() & sp.converged
                 & ((Jk - Jp).abs() / Jp.abs().clamp_min(1.0) < 1e-4))
        log(f"signals: base solves converged in both and in the same basin: {int(basin.sum())} of {B}")
        for name, make in (("analytic", lambda: make_analytic_gradient_batched(P, W, cfg, R, shaped=False)),
                           ("analytic shaped", lambda: make_analytic_gradient_batched(P, W, cfg, R)),
                           ("fd", lambda: make_fd_gradient_batched(P, W, cfg, R))):
            sig = make()
            t0 = time.perf_counter()
            gk, rk = sig(*cuda(args))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gp, rp = sig(*args)
            t2 = time.perf_counter()
            finite = bool(torch.isfinite(gk).all()) and bool(torch.isfinite(gp).all())
            gk, rk = gk.double().cpu()[basin], rk.double().cpu()[basin]
            gp, rp = gp.double()[basin], rp.double()[basin]
            r_rel = float(((rk - rp).abs() / rp.abs().clamp_min(1.0)).median())
            g_rel = (gk - gp).abs() / (gp.abs() + 1e-3 * gp.abs().amax(0).clamp_min(1e-12))
            lane = g_rel.amax(1)
            t_same = float((gk[:, 6] == gp[:, 6]).float().mean())
            sign_same = float((torch.sign(gk[:, :6]) == torch.sign(gp[:, :6])).float().mean())
            log(f"signals {name}: CUDA {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; reward median rel "
                f"{r_rel:.3e}; gradient rel err per lane median {float(lane.median()):.3e}, "
                f"q90 {float(lane.quantile(0.9)):.3e}, max {float(lane.max()):.3e}; lanes within "
                f"1e-2 {float((lane < 1e-2).float().mean()):.4f}; time component equal "
                f"{t_same:.4f}; pos/ang signs equal {sign_same:.4f}; finite {finite}")
            # Gates.  Both paths converge U* to the f32 solver tolerance, so
            # rewards agree to about 1e-5 (gate 1e-4).  The analytic gradient
            # inherits U*'s f32 error through the VJP: median lane within
            # 1e-3, and 80% of lanes within 1e-2.  Why the other lanes
            # differ more is not shown here; the tight check of the signal
            # on the card is f64, 1e-6 on every lane, in tests/test_torch_gpu.py
            # (test_learning_signal_on_card_matches_cpu), and the kernels
            # themselves are held at the training shapes above.
            # The fd signal's position and angle components are reward
            # differences at a 1e-3 step, the size of the f32 solver's noise
            # on the reward, so only its time rule (a jump of more than 2 in
            # reward between the +-0.1 s probes) is gated: equal on 85% of
            # lanes.
            self.check(finite and r_rel < 1e-4, f"signals {name}: reward rel {r_rel:.3e} or non-finite")
            if name.startswith("analytic"):
                ok = float(lane.median()) < 1e-3 and float((lane < 1e-2).float().mean()) >= 0.8
                self.check(ok, f"signals {name}: CUDA gradient outside its gates")
            if name != "analytic":
                self.check(t_same >= 0.85, f"signals {name}: time rule equal on {t_same:.4f} < 0.85")


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
    s.run("7 K3", s.k3)
    s.run("8 train", s.train)
    if s.failures or len(s.kernels) != 3:
        log(f"chip_smoke FAILED: {s.failures}")
        return 1
    # `launches` is the main path's count (phase 4's solve), K3's is phase
    # 7's (it is on no path); `launches_by_path` has each path's own count,
    # the counters set to 0 just before that path and read just after
    by_path = lambda k: {path: n[k] for path, n in s.path_launches.items()}
    src = "learningagileflight_se3_torch/csrc/"
    rows = [
        dict(name="K1 rollout_forward", route="cuda", source=src + "rollout.cu",
             replaces="learningagileflight_se3_tpu/ops/rollout_pallas.py:167",
             launches=s.path_launches["solve"]["K1"], launches_by_path=by_path("K1"),
             **s.kernels["K1"]),
        dict(name="K2 riccati_backward_fused", route="cuda", source=src + "riccati_fused.cu",
             replaces="learningagileflight_se3_tpu/ops/riccati_fused.py:446",
             launches=s.path_launches["solve"]["K2"], launches_by_path=by_path("K2"),
             **s.kernels["K2"]),
        dict(name="K3 riccati_backward_unfused", route="cuda", source=src + "riccati_unfused.cu",
             replaces="learningagileflight_se3_tpu/ops/riccati_pallas.py:364",
             launches=s.k3_launches, launches_by_path={**by_path("K3"), "phase 7": s.k3_launches},
             **s.kernels["K3"]),
    ]
    print(json.dumps({"kernels": rows}))
    print(s.smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
