"""The benchmark's arithmetic on synthetic inputs with known answers: busy
and idle shares from device intervals, idle gaps named by the host, the
rooflines, percentiles and spreads, the rates and the metric readers."""

from __future__ import annotations

import importlib.util
import math
import os

import pytest
import torch

from flightbench import tracing, yardstick
from flightbench.reference.plain import round_tf32
from flightbench.tracing import Op, Trace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  os.path.join(BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeDriver:
    def __init__(self, **counters):
        self.counters = counters


def synthetic_trace():
    # device: [0,10) K2, [5,15) glue (overlaps), [20,30) K1, [40,45) memcpy; span [0,100) ns
    dev = [Op("void laf::riccati_fused_kernel<float>(...)", 0, 10, "kernel"),
           Op("elementwise where", 5, 15, "kernel"),
           Op("void laf::rollout_kernel<float, 4>(...)", 20, 30, "kernel"),
           Op("Memcpy DtoH", 40, 45, "gpu_memcpy")]
    host = [Op("solve", 0, 100, "cpu_op"), Op("cudaStreamSynchronize", 50, 100, "cuda_runtime")]
    return Trace(dev, host, (0, 100))


def test_union_and_gaps():
    assert tracing.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert tracing.union_ns([]) == 0
    assert tracing.union_ns([(0, 10), (10, 20)]) == 20
    assert tracing.gaps_ns([(0, 10), (5, 15), (20, 30)], (0, 40)) == [(15, 20), (30, 40)]
    assert tracing.gaps_ns([(5, 10)], (0, 10)) == [(0, 5)]


def test_busy_idle_and_breakdown():
    tr = synthetic_trace()
    assert tr.busy_s == pytest.approx(30e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.idle_share() == pytest.approx(70.0)
    assert len(tr.kernels()) == 3 and len(tr.kernels(yardstick.K2_KERNEL)) == 1
    top = tr.top_ops(2)
    assert [t[1] for t in top] == pytest.approx([10e-9, 10e-9])
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(55e-9)]  # [45, 100), innermost host op
    assert gaps[1] == ["solve", pytest.approx(10e-9)]                   # [30, 40): longest first
    assert Trace([], [], (0, 0)).idle_share() is None


def test_roofline_known_answers():
    B, H = 2048, 50
    flops = yardstick.K2_FLOPS * B * H
    assert yardstick.bound_s(flops, 0) == pytest.approx(13_000 * 2048 * 50 / 67e12)
    assert yardstick.roofline_pct(flops, 0, 2 * flops / 67e12) == pytest.approx(50.0)
    assert yardstick.roofline_pct(1, 1, 0.0) is None
    # K1 at the bench point is bound by its bytes: 94 values read and 21 written a scenario and step
    k1 = yardstick.k1_bytes(B, H)
    assert k1 == 4 * (H * B * (17 + 4 + 4 + 68 + 1) + B * 11 + H * B * 21 + B)
    assert yardstick.bound_s(yardstick.K1_FLOPS * B * H, k1) == pytest.approx(k1 / 3.35e12)
    assert yardstick.k2_bytes(1, 1) == 4 * (22 + 330 + 72 + 4)


def test_percentile():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert yardstick.percentile(v, 50) == 3.0
    assert yardstick.percentile(v, 75) == 4.0
    assert yardstick.percentile(v, 95) == pytest.approx(4.8)
    assert yardstick.percentile(v, 99) == pytest.approx(4.96)
    assert yardstick.percentile([1.0, 2.0], 50) == 1.5
    assert math.isnan(yardstick.percentile([], 50))


def test_solve_readers():
    tr = synthetic_trace()
    drv = FakeDriver(B=2048, H=50, batches=10, host_reads=140, slice_K2=2, window_s=2.0,
                     flops=67e12 * 2.0 * 0.01)
    assert reader("solve.host_reads_per_batch")(drv, None) == 14.0
    assert reader("solve_mfu")(drv, None) == pytest.approx(1.0)
    # glue: the 10 ns where-kernel over 2 K2 launches -> 5 ns = 5e-6 ms an iteration
    assert reader("solve.glue_ms_per_iter")(drv, tr) == pytest.approx(5e-6)
    k2 = yardstick.bound_s(yardstick.K2_FLOPS * 2048 * 50, yardstick.k2_bytes(2048, 50))
    assert reader("k2_roofline.solve")(drv, tr) == pytest.approx(100 * k2 / 10e-9)
    assert reader("idle_share.solve")(drv, tr) == pytest.approx(70.0)
    assert reader("k2_roofline.solve")(drv, None) is None
    assert reader("solve.glue_ms_per_iter")(FakeDriver(slice_K2=0), tr) is None


def test_flight_readers():
    tr = synthetic_trace()
    drv = FakeDriver(slice_steps=3, K1=600, replans=2)
    assert reader("flight.kernels_per_step")(drv, tr) == pytest.approx(1.0)
    assert reader("flight.k1_per_replan")(drv, None) == 300.0
    assert reader("idle_share.flight")(drv, tr) == pytest.approx(70.0)
    assert reader("flight.kernels_per_step")(drv, Trace([], [], (0, 1))) is None


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.0 + 2.0 ** -12, -2.5])
    r = round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 3.0, -2.5]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((round_tf32(y) - y).abs() / y.abs()).max()
    assert rel <= 2.0 ** -11 + 1e-9


def test_copies_are_told_from_kernels_by_name_where_the_kind_is_missing():
    tr = Trace([Op("Memcpy DtoH (Device -> Pinned)", 0, 5, ""), Op("Memset (Device)", 5, 6, ""),
                Op("void laf::rollout_kernel<float, 4>(...)", 6, 9, "")], [], (0, 10))
    assert [o.name for o in tr.kernels()] == ["void laf::rollout_kernel<float, 4>(...)"]


def test_event_times_from_either_accessor():
    class Ns:
        def start_ns(self):
            return 5

    class Us:
        def start_us(self):
            return 2.5

    assert tracing._ns(Ns(), "start") == 5 and tracing._ns(Us(), "start") == 2500
