"""The port's bindings of the native host library (`native/fastquad.cpp`,
built by `learningagileflight_se3_torch/native.py` into build/native/)
against the port's PyTorch plant, reward and collision score: independent
derivations of the same spec, in float64 on the CPU.  Skipped where no C++
toolchain exists, as tests/test_native.py is."""

import hashlib
import os

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch import native
from learningagileflight_se3_torch.config import QuadParams, RewardConfig
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step, rollout
from learningagileflight_se3_torch.geometry.collision import collision_score, trajectory_reward
from learningagileflight_se3_torch.geometry.gate import gate_from_width, rotate_y

PQ = QuadParams()
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _library():
    """Build the library once per worker, in a test and not at import."""
    if not native.available():
        pytest.skip("no C++ toolchain / libfastquad build failed")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def hover_start(rng):
    x0 = np.zeros(13)
    x0[0:3] = rng.uniform(-2, 2, 3)
    q = np.concatenate([[1.0], 0.1 * rng.normal(size=3)])
    x0[6:10] = q / np.linalg.norm(q)
    x0[10:13] = 0.1 * rng.normal(size=3)
    return x0


def test_built_outside_the_tracked_library():
    """The port compiles into build/native/ and never rewrites the JAX
    package's tracked native/libfastquad.so."""
    tracked = os.path.join(os.path.dirname(native.SOURCE), "libfastquad.so")
    before = hashlib.sha256(open(tracked, "rb").read()).hexdigest() if os.path.exists(tracked) else None
    path = native.library()._name
    assert os.path.dirname(path) == native.BUILD_DIR
    after = hashlib.sha256(open(tracked, "rb").read()).hexdigest() if os.path.exists(tracked) else None
    assert before == after


def test_euler_step_matches_library(rng):
    for _ in range(20):
        x = rng.normal(size=13)
        x[6:10] /= np.linalg.norm(x[6:10])
        u = rng.uniform(0, 2.44, size=4)
        got = euler_step(t64(x), t64(u), 0.01, PQ).numpy()
        np.testing.assert_allclose(got, native.euler_step(x, u, 0.01, PQ), rtol=0, atol=1e-13)


def test_rollout_matches_library(rng):
    """The port's batched rollout against the library's, 8 seeded (x0, U)
    pairs at H=30 around hover (states within about 10 m and 10 m/s, so
    that 1e-13 is a few ulp)."""
    x0 = np.stack([hover_start(rng) for _ in range(8)])
    U = PQ.mass * PQ.g / 4 + rng.uniform(-0.02, 0.02, size=(8, 30, 4))
    X = rollout(t64(x0), t64(U), 0.1, PQ).numpy()
    for i in range(8):
        np.testing.assert_allclose(X[i], native.rollout(x0[i], U[i], 0.1, PQ), rtol=0, atol=1e-13)


def test_reward_matches_library(rng):
    cfg = RewardConfig()
    H = 12
    x0 = np.zeros(13)
    x0[0:3] = [0.1, -4.0, 0.0]
    x0[6] = 1.0
    U = rng.uniform(1.0, 1.4, size=(H, 4))
    states = rollout(t64(x0), t64(U), 0.1, PQ)
    gate = rotate_y(gate_from_width(torch.tensor(1.0, dtype=F64)), torch.tensor(0.3, dtype=F64))
    goal = t64([0.0, 4.0, 0.0])
    r, col, path, _ = trajectory_reward(states, gate, goal, cfg, H)
    r_n, col_n, path_n = native.trajectory_reward(states.numpy(), gate.numpy(), goal.numpy(), H)
    np.testing.assert_allclose(float(r), r_n, rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(col), col_n, rtol=0, atol=1e-11)
    np.testing.assert_allclose(float(path), path_n, rtol=0, atol=1e-10)


def test_collision_score_matches_library(rng):
    gate = np.array([[-0.6, 0, 1.0], [0.6, 0, 1.0], [0.6, 0, -1.0], [-0.6, 0, -1.0]])
    for _ in range(10):
        traj = np.linspace(rng.uniform(-2, 2, 3) + [0, -4, 0], rng.uniform(-2, 2, 3) + [0, 4, 0], 25)
        got, _ = collision_score(t64(gate), t64(traj), len(traj) - 1, 0.2)
        np.testing.assert_allclose(float(got), native.collision_score(gate, traj, len(traj) - 1), rtol=0, atol=1e-10)


def test_sampler_deterministic_and_in_range():
    a = native.sample_scenarios(seed=3, n=16)
    np.testing.assert_array_equal(a, native.sample_scenarios(seed=3, n=16))
    assert not np.array_equal(a, native.sample_scenarios(seed=4, n=16))
    scen = native.sample_scenarios(seed=7, n=2000)
    assert scen.shape == (2000, 9)
    assert scen[:, 0].min() >= -5 and scen[:, 0].max() <= 5
    assert scen[:, 7].min() >= 0.5 and scen[:, 7].max() <= 1.25
