"""Scaling of the batched solve and of the RL step over processes: the
port's bench_scaling.py.

  (a) Weak scaling on silicon: for each count of cards present (1, 2, 4, 8
      up to the card count), one NCCL process a card, each solving 2048
      lanes of bench.py's problem (PRNGKey(0)'s draw, the same on every
      card) at H=50, 30 DDP iterations, tol 1e-4, gtol 3e-4, f32; the
      median of 3 synced reps, each ended by a barrier.  The efficiency is
      solves/s at the largest count over that count times solves/s on one
      card; with one card there is nothing to divide, and `value` is null.
  (b) The multi-process rows: scaling_worker.py's global batch (64 lanes,
      PRNGKey(0)'s draw), H=20, 8 DDP iterations, 3 reps, in one process
      against two (each solving its half), in the `solve` and `trainstep`
      (the whole sharded RL step) modes: with gloo on the CPU, as the JAX
      rows ran, and with gloo ranks sharing the one card.

Every rank writes its output to a log file under `log_dir`, never to a
pipe.  XLA's virtual host devices (the JAX record's
`virtual_mesh_sharding_parity`) have no PyTorch counterpart: one process
runs one device here.  Its key stays, null, with a note.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from learningagileflight_se3_torch.benchmarks.harness import card_fields, log, prepare
from learningagileflight_se3_torch.benchmarks.problems import bench_args, scenarios
from learningagileflight_se3_torch.benchmarks.scaling_worker import solve_rank, trainstep_rank
from learningagileflight_se3_torch.parallel.dryrun import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOG_DIR = os.path.join(REPO, "runs", "torch_bench_scaling")
RANKS_TIMEOUT_S = 600.0  # bench_scaling.py's wait for its workers
PER_CARD = 2048


def _ranks(fn, n, device, backend, args, log_dir, name):
    """run_ranks with the ranks' log tails on stderr when one fails."""
    try:
        return run_ranks(fn, n, device=device, backend=backend, args=args + (log_dir, name), scratch_dir=log_dir,
                         timeout_s=RANKS_TIMEOUT_S)
    except (RuntimeError, TimeoutError):
        for r in range(n):
            path = os.path.join(log_dir, f"{name}.rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    log(f"{name} rank {r}: {f.read()[-2000:]}")
        raise


def card_counts(n_cards: int) -> list:
    """The counts of cards the silicon row measures: 1, 2, 4, 8 up to n_cards."""
    return [n for n in (1, 2, 4, 8) if n <= n_cards]


def solve_problem(scen, traversal_attitude: bool) -> tuple:
    """The solve ranks' global problem from scenarios `scen` (numpy): the
    solver's six arguments as float32 arrays, bench.py's problem
    (bench_args) with its traversal attitude, or with a zero one as
    scaling_worker.py solves it."""
    args = [a.numpy() for a in bench_args(scen, "cpu")]
    if not traversal_attitude:
        args[4] = np.zeros_like(args[4])
    return tuple(args)


def silicon_row(n: int, horizon: int = 50, iters: int = 30, reps: int = 3, log_dir: str = LOG_DIR) -> dict:
    """Weak scaling on n cards: solves/s of PER_CARD lanes a card (the median
    over the reps of the slowest rank's time), and the ranks' launches."""
    os.makedirs(log_dir, exist_ok=True)
    problem = solve_problem(np.tile(scenarios(0, 2048)[:PER_CARD], (n, 1)), traversal_attitude=True)
    ranks = _ranks(solve_rank, n, "cuda", "nccl", (problem, horizon, iters, reps), log_dir, f"silicon_{n}")
    rep_s = np.max([r["rep_s"] for r in ranks], axis=0)
    sps = PER_CARD * n / float(np.median(rep_s))
    log(f"cards={n}: batch {PER_CARD * n}, {sps:.1f} solves/s (median of {reps}; spread "
        f"{rep_s.min():.3f}-{rep_s.max():.3f} s)")
    return dict(solves_per_sec=sps, launches=[r["launches"] for r in ranks])


def mp_rates(mode: str, device: str, batch: int = 64, horizon: int = 20, iters: int = 8, reps: int = 3,
             log_dir: str = LOG_DIR) -> dict:
    """{1: rate, 2: rate} of `mode` ("solve" or "trainstep") with gloo ranks
    on `device` (solves/s or steps/s over the reps, rank 0's clock; every
    rep ends in a barrier), and {n: each rank's launches}."""
    os.makedirs(log_dir, exist_ok=True)
    scen = scenarios(0, 64)[:batch]
    fn, data = ((solve_rank, solve_problem(scen, traversal_attitude=False)) if mode == "solve"
                else (trainstep_rank, scen))
    rates, launches = {}, {}
    for nproc in (1, 2):
        where = "cpu" if torch.device(device).type == "cpu" else "card"
        ranks = _ranks(fn, nproc, device, "gloo", (data, horizon, iters, reps), log_dir, f"mp_{mode}_{where}_{nproc}")
        elapsed = ranks[0]["elapsed_s"]
        rates[nproc] = (batch if mode == "solve" else 1) * reps / elapsed
        launches[nproc] = [r["launches"] for r in ranks]
        log(f"multi-process [{mode}, {where}] nproc={nproc}: {rates[nproc]:.3f} "
            f"{'solves' if mode == 'solve' else 'steps'}/s")
    return dict(rates=rates, launches=launches)


def mp_row(rates: dict, mode: str, backend: str, batch: int = 64, horizon: int = 20, reps: int = 3) -> dict:
    """bench_scaling.py's multi-process row from {1: rate, 2: rate}."""
    key = "steps_per_sec" if mode == "trainstep" else "solves_per_sec"
    return {
        f"{key}_1proc": round(rates[1], 2),
        f"{key}_2proc": round(rates[2], 2),
        "parity_2proc_vs_1proc": round(rates[2] / rates[1], 3),
        "mode": mode,
        "batch": batch,
        "horizon": horizon,
        "reps": reps,
        "backend": backend,
    }


def assemble(sps: dict, n_cards: int, cores: int, card: dict, multiprocess=None, multiprocess_trainstep=None,
             multiprocess_card=None, multiprocess_trainstep_card=None) -> dict:
    """bench_scaling.py's JSON fields from the silicon rows `sps` ({cards:
    solves/s}) and the multi-process rows (mp_row dicts or None)."""
    counts = sorted(sps)
    gate_n = counts[-1] if counts else None
    eff = sps[gate_n] / (gate_n * sps[1]) if counts and gate_n > 1 else None
    return {
        "metric": "weak_scaling_efficiency",
        "value": None if eff is None else round(float(eff), 3),
        "unit": "fraction",
        "vs_baseline": None if eff is None else round(float(eff), 3),
        "devices_gated": gate_n,
        "physical_cores": cores,
        "solves_per_sec": {str(k): round(v, 1) for k, v in sps.items()},
        "parity_per_count": {str(n): round(sps[n] / sps[1], 3) for n in counts},
        **card,
        "virtual_mesh": False,
        "multiprocess": multiprocess,
        "multiprocess_trainstep": multiprocess_trainstep,
        "cards": n_cards,
        "virtual_mesh_sharding_parity": None,
        "multiprocess_card": multiprocess_card,
        "multiprocess_trainstep_card": multiprocess_trainstep_card,
        "notes": {
            "value": ("solves/s on the most cards over that count times one card's; null with one card "
                      "(nothing to divide)" if eff is None else
                      "solves/s on the most cards over that count times one card's"),
            "virtual_mesh_sharding_parity": ("XLA's virtual host devices have no PyTorch counterpart: "
                                             "a process runs one device"),
            "multiprocess": "gloo ranks on the CPU, one process against two (the JAX rows' arrangement)",
            "multiprocess_card": "gloo ranks sharing the one card, one process against two",
        },
    }


def run(device="cuda", cpu_rows: bool = True, modes=("solve", "trainstep"), log_dir: str = LOG_DIR) -> dict:
    """bench_scaling.py's JSON fields for the port: the silicon rows on
    every count of cards `device` offers (the card unless given "cpu", where
    there is none), the multi-process rows on the CPU (cpu_rows) and on the
    card where there is one, in `modes`.  "launches" holds each run's ranks'
    kernel counts ({run: [rank's counts]})."""
    device = prepare(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    sps, launches = {}, {}
    for n in card_counts(n_cards):
        row = silicon_row(n, log_dir=log_dir)
        sps[n], launches[f"silicon_{n}"] = row["solves_per_sec"], row["launches"]
    rows = {}
    for where, on in (("cpu", cpu_rows), ("card", n_cards > 0)):
        for mode in modes if on else ():
            r = mp_rates(mode, "cpu" if where == "cpu" else str(device), log_dir=log_dir)
            backend = ("torch.distributed + gloo, CPU" if where == "cpu"
                       else "torch.distributed + gloo, ranks sharing one card")
            rows[mode, where] = mp_row(r["rates"], mode, backend)
            launches.update({f"mp_{mode}_{where}_{n}": r["launches"][n] for n in (1, 2)})
    out = assemble(sps, n_cards, os.cpu_count() or 1, card_fields(device),
                   multiprocess=rows.get(("solve", "cpu")),
                   multiprocess_trainstep=rows.get(("trainstep", "cpu")),
                   multiprocess_card=rows.get(("solve", "card")),
                   multiprocess_trainstep_card=rows.get(("trainstep", "card")))
    out["launches"] = launches
    return out
