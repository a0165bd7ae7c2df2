"""Time the PyTorch port's K1, K2 and K3 against another checkout's, on one card.

Builds the CUDA kernels of this tree and of another checkout of the
repository (`--other DIR`, for example the parent commit unpacked with `git
archive`), each with its own sources and nvcc flags, and times both on the
same inputs: the solver's trajectories after 10 DDP iterations (as
chip_smoke.py phase 3), f32, H=50, B = 2048, 256 and 1; K3 on the
derivatives that ops/riccati_unfused.py derivatives_plain forms from K2's
inputs.  Each launch goes straight to the C entry point with preallocated
outputs; the card spins for about a millisecond before the start event, so
the events time the card's work alone.  The two builds are timed in turns
(other, this, this, other), 20 launches each, and the backward sweeps'
outputs compared (K2's and K3's KK relative error, fail pattern).  Prints
one JSON line per shape and one JSON object, also written to `--out`.

Usage: python3 scripts/compare_kernels.py --other DIR [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig  # noqa: E402
from learningagileflight_se3_torch.ops import build  # noqa: E402
from learningagileflight_se3_torch.ops.inputs import main_path_inputs  # noqa: E402
from learningagileflight_se3_torch.ops.riccati_unfused import derivatives_plain  # noqa: E402

H, N = 50, 20


def load_build(root):
    """The ops/build.py module of the checkout at `root`, building from its own csrc/."""
    path = os.path.join(root, "learningagileflight_se3_torch", "ops", "build.py")
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def card_ms(fn):
    """Median over N launches of the card's time for fn (CUDA events)."""
    fn()
    times = []
    for _ in range(N):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    builds = {"other": load_build(os.path.abspath(args.other)), "this": build}
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
    stream = torch.cuda.current_stream().cuda_stream
    result = dict(device=smi, other=os.path.abspath(args.other), shapes=[])
    for B in (2048, 256, 1):
        k1, k2 = main_path_inputs(H, B, device="cuda", iters=10)
        a1 = [x.float() for x in k1]
        a2 = [x.float() for x in k2]
        a3 = [x.float() for x in derivatives_plain(*k2, P, W, C)]
        row = dict(B=B)
        outs = {}
        for name, mod in builds.items():
            lib, consts = mod.library().lib, mod.kernel_consts(P, W, C, C.boxqp_iters, C.use_ddp)
            kw = dict(device="cuda")
            sweep = lambda: [torch.empty((H, 4, B), **kw), torch.empty((H, 4, 17, B), **kw)] + [
                torch.empty((B,), **kw) for _ in range(4)]
            o1, o2, o3 = [torch.empty((H, 17, B), **kw), torch.empty((H, 4, B), **kw),
                          torch.empty((B,), **kw)], sweep(), sweep()
            p1, p2, p3 = ([t.data_ptr() for t in a + o] for a, o in ((a1, o1), (a2, o2), (a3, o3)))
            outs[name] = ({"K2": o2, "K3": o3},
                          {"K1": lambda lib=lib, c=consts, p=p1: lib.laf_rollout_f32(ctypes.byref(c), H, B, *p,
                                                                                    stream),
                           "K2": lambda lib=lib, c=consts, p=p2: lib.laf_riccati_fused_f32(ctypes.byref(c), H, B,
                                                                                          *p, stream),
                           "K3": lambda lib=lib, c=consts, p=p3: lib.laf_riccati_unfused_f32(ctypes.byref(c), H,
                                                                                            B, *p, stream)})
        for name in ("other", "this", "this", "other"):
            for k, fn in outs[name][1].items():
                row.setdefault(f"{k}_ms_{name}", []).append(card_ms(fn))
        torch.cuda.synchronize()
        for k in ("K2", "K3"):
            oa, ob = outs["other"][0][k], outs["this"][0][k]
            KK_a, KK_b = oa[1].double(), ob[1].double()
            both = torch.isfinite(KK_a) & torch.isfinite(KK_b)
            row[f"{k}_KK_rel_err_this_vs_other"] = float(
                ((KK_b - KK_a).abs() / (KK_a.abs() + 1e-2))[both].max()) if bool(both.any()) else 0.0
            row[f"{k}_fail_equal"] = bool(((oa[4] > 0) == (ob[4] > 0)).all())
            row[f"{k}_fail_lanes_this"] = int((ob[4] > 0).sum())
        result["shapes"].append(row)
        print(json.dumps(row), flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
