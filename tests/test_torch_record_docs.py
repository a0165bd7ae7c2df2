"""README.md's "PyTorch port" numbers against the port's records
(`learningagileflight_se3_torch/records/*.json`), through
`scripts/torch_doc_claims.py`: each number the README quotes is derived from
its record with the README's formatting and must appear verbatim."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.torch_doc_claims import RECORDS, claims, missing  # noqa: E402


def readme():
    with open(os.path.join(REPO, "README.md")) as f:
        return f.read()


def test_readme_numbers_match_port_records():
    gone = missing(readme())
    assert not gone, "README numbers drifted from the port's records:\n  " + "\n  ".join(gone)


def test_every_record_is_quoted():
    """Each record file under records/ gives at least one claim, its card's
    name and power limit among them."""
    by_record = {}
    for name, claim, _ in claims():
        by_record.setdefault(name, []).append(claim)
    assert sorted(by_record) == sorted(f for f in os.listdir(RECORDS) if f.endswith(".json"))
    assert all(any(" at " in c and c.endswith(" W") for c in cs) for cs in by_record.values())


def test_check_fails_on_the_old_solve_figure():
    """The README with an earlier run's 7,321 solves/s, which it once quoted,
    in place of the solve record fails the check, on that claim alone."""
    solve = next(c for name, c, _ in claims() if name == "bench_solve.json" and "synced" in c)
    text = readme()
    assert solve in text
    gone = missing(text.replace(solve, "7,321 solves/s"))
    assert len(gone) == 1 and gone[0].startswith("bench_solve.json:") and "synced" in gone[0]
