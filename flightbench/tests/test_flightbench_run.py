"""The command as the benchmark's check runs it: without a card, and in a
folder that holds only BENCHMARK.json and the benchmark, it prints no
result and exits with another code than 0; on the card (marker `gpu`) each
cell prints the contract's last line, correct."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def command(cell: str, seconds: float, trace: int, seed: int = 2**31 + 99) -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cmd = json.load(f)["command"]
    return [sys.executable] + cmd[1:] + ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                                         "--trace", str(trace)]


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    shutil.copytree(os.path.join(ROOT, "flightbench"), bare / "flightbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    dirs = [str(bare)] + ([] if torch.cuda.is_available() else [ROOT])
    for cwd in dirs:
        env = dict(os.environ, PYTHONPATH="")
        p = subprocess.run(command("solve.main.b2048", 1, 0), cwd=cwd, capture_output=True, text=True,
                           timeout=600, env=env)
        assert p.returncode != 0 and p.stdout.strip() == "", (cwd, p.stdout[-500:], p.stderr[-2000:])


@pytest.mark.gpu
@pytest.mark.parametrize("cell,trace", [("solve.main.b2048", 0), ("flight.main.b128", 1)])
def test_a_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(command(cell, 2, trace), cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]
