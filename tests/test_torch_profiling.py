"""PyTorch port, utils/profiling.py: the checks of tests/test_utils.py's
TestStageTimer on the port's StageTimer and device_trace, on the CPU."""

import json
import os

import torch

from learningagileflight_se3_torch.utils.profiling import StageTimer, device_trace


def test_stage_timer_accumulates_and_reports():
    timer = StageTimer()
    for _ in range(3):
        with timer("compute"):
            x = timer.block(torch.ones((64, 64)) @ torch.ones((64, 64)))
    with timer("other", block={"x": x, "y": [x, (x,)]}):
        pass
    lines = []
    totals = timer.report(log_fn=lines.append)
    assert set(totals) == {"compute", "other"}
    assert timer.counts["compute"] == 3 and timer.counts["other"] == 1
    assert totals["compute"] > 0
    assert len(lines) == 2 and "compute" in lines[0] and "x3" in lines[0]


def test_device_trace_writes(tmp_path):
    d = str(tmp_path / "trace")
    with device_trace(d):
        (torch.arange(8.0) * 2.0).sum()
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert json.load(f)["traceEvents"], "no event in the trace"


def test_device_trace_none_is_noop():
    with device_trace(None):
        pass
