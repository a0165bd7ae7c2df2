"""PyTorch port, utils/profiling.py's spans on the CPU.

Spans are named intervals of the hot paths on the host's clock: device
spans, pairs of stamps the work writes (on the card from inside CUDA graphs
and their conditional bodies; on the CPU when they are queued, which is
when they run), host spans around the host calls, and counters the work
adds to.  Here: with spans off nothing is recorded and the outputs are
the same bit for bit as with them on; a CPU flight's spans are one a step,
nested as the step graphs capture them; the t-solver's counter is the eager
loop's iteration count; the arithmetic on synthetic stamps (pairing, the
clock's map, the card's waits and what they are put down to, the cases
that cannot be read); and the graphs' keys follow the spans' state.  The
stamp kernel itself runs on the card (chip_smoke.py phase 20).
"""

import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops.inputs import bench_problems
from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
from learningagileflight_se3_torch.sim.tsolver import TraversalTimeSolver
from learningagileflight_se3_torch.solver import ilqr_batched
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.utils import graphs, profiling
from learningagileflight_se3_torch.utils.profiling import clock_map, pair, spans, summarize
from learningagileflight_se3_torch.utils.weights import bench_scenarios, bench_scenarios_path, load_dnn2

STEPS, EVERY = 30, 10


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    yield
    spans.disable()


@pytest.fixture(scope="module")
def dnn2():
    return load_dnn2().double()


@pytest.fixture(scope="module")
def scenarios():
    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    return scen[:4], noise[:4, :STEPS]


def _sim(dnn2):
    cfg = SolverConfig(horizon=10, max_iters=8, tol=1e-4, gtol=3e-4, no_progress_iters=10)
    return make_closed_loop_sim(dnn2, solver_cfg=cfg, steps=STEPS, control_every=EVERY, device="cpu",
                                dtype=torch.float64)


def _run(case, dnn2, scenarios):
    """The outputs of one case: a flight under a drive, or a batched solve."""
    if case.startswith("flight"):
        scen, noise = scenarios
        return tuple(_sim(dnn2)(scen, gate_noise=noise, drive=case.split("-")[1]))
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(),
                                     SolverConfig(horizon=10, max_iters=9, tol=1e-4, gtol=3e-4,
                                                  no_progress_iters=10, ls_max_trips=4, ls_adaptive=True))
    return tuple(solver(*bench_problems(6, "cpu", seed=2), drive=case.split("-")[1]))


@pytest.mark.parametrize("case", ["flight-eager", "flight-blocks", "solve-eager", "solve-blocks"])
def test_spans_off_record_nothing_and_on_change_nothing(case, dnn2, scenarios):
    """Spans off: no stamp, host span or count; on: the same outputs bit for bit."""
    spans.enable("cpu")
    spans.disable()
    off = _run(case, dnn2, scenarios)
    got = spans.collect()
    assert got["device"] == [] and got["host"] == [] and got["stamps"] == 0
    assert all(c == [0, 0] for c in got["counters"].values())
    spans.enable("cpu")
    on = _run(case, dnn2, scenarios)
    got = spans.collect()
    assert got["stamps"] > 0 and got["host"] and got["unpaired"] == 0
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("drive", ["eager", "blocks"])
def test_a_flights_spans_are_one_a_step_and_nested(drive, dnn2, scenarios):
    """30 steps at a replan every 10: a flight.step, a flight.tsolve and the
    host's launch, inputs (static buffers only) and log a step, a
    flight.replan every 10 steps, each pair inside its step, the solve's
    spans inside the replans, one prepare and one finish."""
    scen, noise = scenarios
    spans.enable("cpu")
    _sim(dnn2)(scen, gate_noise=noise, drive=drive)
    got = spans.collect()
    by = {}
    for name, s, e in got["device"]:
        assert s <= e
        by.setdefault(name, []).append((s, e))
    steps, tsolves, replans = by["flight.step"], by["flight.tsolve"], by["flight.replan"]
    assert len(steps) == len(tsolves) == STEPS and len(replans) == STEPS // EVERY
    for i, (s, e) in enumerate(steps):
        assert steps[i - 1][1] <= s if i else True
        inside = lambda spans_: [x for x in spans_ if s <= x[0] and x[1] <= e]  # noqa: E731
        assert len(inside(tsolves)) == 1
        assert len(inside(replans)) == (1 if i % EVERY == 0 else 0)
    for name in ("solve.setup", "solve.solution"):
        assert len(by[name]) == STEPS // EVERY
        assert all(any(r[0] <= s and e <= r[1] for r in replans) for s, e in by[name])
    assert ("solve.block" in by) == (drive == "blocks")
    host = {}
    for name, _, _ in got["host"]:
        host[name] = host.get(name, 0) + 1
    assert host["flight.prepare"] == host["flight.finish"] == 1
    assert host["flight.launch"] == host["flight.log"] == STEPS
    assert host.get("flight.inputs", 0) == (STEPS if drive == "blocks" else 0)


def test_the_tsolver_counter_is_the_eager_loops_iterations(dnn2, scenarios, monkeypatch):
    """The counter "flight.tsolve" of a flight with spans on: [0, the
    iterations the eager loops ran] (each fixed point's final carry counts
    its own), under the eager drive and the step graphs' blocks alike."""
    scen, noise = scenarios
    real, iters = TraversalTimeSolver.run, []

    def spy(*a, **kw):
        end = real(*a, **kw)
        iters.append(int(end.it))
        return end

    monkeypatch.setattr(TraversalTimeSolver, "run", spy)
    counts, n = {}, {}
    for drive in ("eager", "blocks"):
        iters.clear()
        spans.enable("cpu")
        _sim(dnn2)(scen, gate_noise=noise, drive=drive)
        counts[drive], n[drive] = spans.collect()["counters"]["flight.tsolve"], list(iters)
    assert len(n["eager"]) == STEPS and sum(n["eager"]) > STEPS and n["blocks"] == n["eager"]
    assert counts["eager"] == counts["blocks"] == [0, sum(n["eager"])]


# ------------------------------------------------------------ synthetic stamps

NAMES = ["a", "b"]  # a: id 0 opens, 1 closes; b: 2 and 3


@pytest.mark.parametrize("stamps,spans_,unpaired", [
    ([(0, 10), (1, 20)], [("a", 10, 20)], 0),
    ([(0, 10), (2, 12), (3, 18), (1, 20)], [("a", 10, 20), ("b", 12, 18)], 0),   # b inside a
    ([(0, 10), (0, 12), (1, 18), (1, 20)], [("a", 10, 20), ("a", 12, 18)], 0),   # a inside a
    ([(1, 5), (0, 10), (1, 20), (2, 30)], [("a", 10, 20)], 2),                   # a lone end, a lone start
], ids=["one", "nested", "same name nested", "unpaired"])
def test_pairing(stamps, spans_, unpaired):
    assert pair(stamps, NAMES) == (spans_, unpaired)


def test_the_clock_map():
    """Two calibrations 1 s apart on the card and 0.999999 s on the host: the
    card runs 1 ppm fast; a stamp between them lands on the line; the error
    is the larger calibration's."""
    to_host, clock = clock_map((1_000, 50_000, 3_000), (1_000_001_000, 50_000 + 999_999_000, 7_000))
    assert to_host(1_000) == 50_000 and to_host(1_000_001_000) == 50_000 + 999_999_000
    assert to_host(500_001_000) == 50_000 + 499_999_500
    assert clock["err_ns"] == 7_000 and clock["drift_ppm"] == pytest.approx(1.0, rel=1e-5)
    same, clock = clock_map((10, 20, 0), (10, 20, 0))
    assert same(15) == 25 and clock == {"err_ns": 0, "drift_ppm": 0.0}


def _got(device, host=(), window=(0, 100), err=1_000, overflow=False):
    return {"window": window, "device": list(device), "host": list(host), "counters": {"n": [1, 2]},
            "clock": {"err_ns": err, "drift_ppm": 0.5}, "overflow": overflow, "stamps": 2 * len(device),
            "unpaired": 0}


# window [0, 100): work [10, 30) and [50, 90), so waits [0, 10), [30, 50) and
# [90, 100), whose middles 5, 40 and 95 fall in launch, read (inside launch,
# the innermost) and log; "in" and "x" are not work
DEVICE = [("w", 10, 30), ("in", 12, 20), ("w", 50, 90), ("x", 95, 120)]
HOST = [("launch", 0, 48), ("read", 30, 45), ("log", 85, 99)]


@pytest.mark.parametrize("case,got,expect", [
    ("waits put down to the innermost host span, or to the caller", _got(DEVICE, HOST),
     {"work_ns": 60, "wait_ns": 40, "waits": {"launch": 10, "read": 20, "log": 10}}),
    ("work spans clipped to the window", _got([("w", -10, 30), ("w", 50, 130)], HOST),
     {"work_ns": 80, "wait_ns": 20, "waits": {"read": 20}}),
    ("no work span: all wait, its middle in no host span", _got([], HOST),
     {"work_ns": 0, "wait_ns": 100, "waits": {"caller": 100}}),
    ("overflow", _got(DEVICE, HOST, overflow=True), None),
    ("the clock's error over 50 us", _got(DEVICE, HOST, err=50_001), None),
    ("overlapping work spans miss the wall", _got([("w", 0, 60), ("w", 40, 100)]), None),
])
def test_summarize(case, got, expect):
    s = summarize(got, ["w"])
    if expect is None:
        assert s is None
        return
    assert s["wall_ns"] == 100 and s["work_ns"] + s["wait_ns"] == 100 and s["misfit"] == 0
    for k, v in expect.items():
        assert s[k] == v, (case, k)
    assert s["counters"] == {"n": [1, 2]} and s["clock"]["err_ns"] == 1_000


def test_summarize_counts_the_spans_inside_the_window():
    s = summarize(_got(DEVICE, HOST), ["w"])
    assert s["spans"] == {"w": [2, 60], "in": [1, 8]}  # "x" ends after the window


def test_stamps_past_the_ring_are_counted_and_the_window_is_not_read(monkeypatch):
    monkeypatch.setattr(profiling.Spans, "CAP", 4)
    ring = profiling.Spans()
    ring.enable("cpu")
    for _ in range(3):
        with ring.device("a", "cpu"):
            pass
    got = ring.collect()
    assert got["stamps"] == 6 and got["overflow"] is True and len(got["device"]) == 2
    assert summarize(got, ["a"]) is None


# ------------------------------------------------------------ graph keys

def test_the_graph_keys_follow_the_spans_state(dnn2, monkeypatch):
    """The solver's graph keys differ with the spans on and off, and the
    closed loop captures its step graphs once for each state (a capture
    stood in for by one that records it).  (The t-solver keeps no graph:
    on the card it is one kernel.)"""
    solver = make_batched_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=10, max_iters=4))
    s, _, _ = solver.setup(*bench_problems(3, "cpu", seed=1))
    off = solver._key(s)
    spans.enable("cpu")
    assert solver._key(s) != off

    captured = []

    class Replay:
        def replay(self):
            pass

    def capture(self, fn, warmup=None):
        captured.append(spans.on)
        return graphs.Graph(Replay(), None, (0, 0, 0, 0))

    monkeypatch.setattr(graphs.Captures, "capture", capture)
    monkeypatch.setattr(ilqr_batched.BatchedSolver, "graphed", lambda self, device: True)
    sim = _sim(dnn2)
    scen, noise = bench_scenarios(bench_scenarios_path(2024))
    for on in (False, False, True, True, False):
        (spans.enable if on else lambda d: spans.disable())("cpu")
        sim(scen[:2], gate_noise=noise[:2, :STEPS], drive="graph")
    assert captured == [False, False, True, True]
