"""The numbers that README.md's "PyTorch port" section quotes from the port's
records, derived from the records.

The counterpart of `scripts/doc_claims.py` (which reads `artifacts/`, the
JAX package's records) for `learningagileflight_se3_torch/records/*.json`:
every number the README quotes from a port record is formatted here from
the committed JSON as the README writes it, and
`tests/test_torch_record_docs.py` asserts that each formatted claim appears
in the README verbatim once whitespace is normalised.  A README number
edited without re-running its record, or a record re-run without the
README, fails the test.

Usage:
  python scripts/torch_doc_claims.py          # print every claim and whether the README has it
  pytest tests/test_torch_record_docs.py      # enforce
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.doc_claims import claim_in_doc  # noqa: E402

RECORDS = os.path.join(REPO, "learningagileflight_se3_torch", "records")
DOC = "README.md"


def _load(name):
    with open(os.path.join(RECORDS, name)) as f:
        return json.load(f)


def _exp(x: float) -> str:
    """1.06e-8, as the README writes a small number."""
    return f"{x:.2e}".replace("e-0", "e-")


def _card(platform: str, power_limit: str) -> str:
    return f"{platform} at {power_limit}"


def claims():
    """-> list of (record file, claim substring, source key)."""
    solve, check, lat = _load("bench_solve.json"), _load("bench_kernel_check.json"), _load("bench_latency.json")
    rt, acc, scal = _load("bench_realtime.json"), _load("bench_accuracy.json"), _load("bench_scaling.json")
    rl, imi = _load("ablate_rl.json"), _load("ablate_imitation.json")
    out = [
        ("bench_solve.json", f"{solve['value']:,.0f} solves/s ({solve['sync_solves_per_sec']:,.0f} synced)",
         "value, sync_solves_per_sec"),
        ("bench_solve.json",
         f"{solve['frac_within_1pct_of_converged'] * 100:.2f}% of lanes within 1% of the golden run",
         "frac_within_1pct_of_converged"),
        ("bench_solve.json", f"the certified tier at {solve['certified_tier']['frac_within_1pct'] * 100:.1f}%",
         "certified_tier.frac_within_1pct"),
        ("bench_kernel_check.json", f"same basin {check['frac_same_basin_converged']:.4f}",
         "frac_same_basin_converged"),
        ("bench_latency.json", f"a warm-started B=1 query takes {lat['value'] * 1e3:.1f} ms", "value"),
        ("bench_realtime.json", f"succeeds on {rt['success_rate'] * 100:.3f}% of its {rt['n_scenarios']} scenarios",
         "success_rate, n_scenarios"),
        ("bench_accuracy.json", f"mean control MAE {_exp(acc['value'])}", "value"),
        ("bench_scaling.json", f"one card {scal['solves_per_sec']['1']:,.1f} solves/s", "solves_per_sec.1"),
        ("ablate_rl.json", f"`analytic400sched` {rl['results']['analytic400sched']['reward_mean']:+.2f} and "
         f"`fd400sched` {rl['results']['fd400sched']['reward_mean']:+.2f} mean reward",
         "results.{analytic400sched,fd400sched}.reward_mean"),
        ("ablate_imitation.json", "imitation success " + " / ".join(
            f"{imi['results'][k]['success_rate']:.3f}" for k in ("world", "window", "window_consistent"))
         + " (world, window, window_consistent", "results.*.success_rate"),
    ]
    for name in ("bench_solve.json", "bench_kernel_check.json", "bench_latency.json", "bench_realtime.json",
                 "bench_accuracy.json", "bench_scaling.json"):
        rec = _load(name)
        out.append((name, _card(rec["platform"], rec["power_limit"]), "platform, power_limit"))
    for name, rec in (("ablate_rl.json", rl), ("ablate_imitation.json", imi)):
        out.append((name, _card(*rec["meta"]["platform"].split(", ")), "meta.platform"))
    return out


def missing(doc_text: str):
    """The claims that `doc_text` lacks, each as "record: claim (source)"."""
    return [f"{name}: {claim!r} ({src})" for name, claim, src in claims() if not claim_in_doc(claim, doc_text)]


def main():
    with open(os.path.join(REPO, DOC)) as f:
        text = f.read()
    for name, claim, src in claims():
        print(f"[{'ok' if claim_in_doc(claim, text) else 'MISSING'}] {DOC}: {claim!r}   <- {name}:{src}")


if __name__ == "__main__":
    main()
