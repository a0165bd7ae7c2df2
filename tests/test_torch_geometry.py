"""PyTorch port, the rest of the rotation, dynamics, gate and sampler layers.

On the CPU, against the JAX package on the same numpy inputs made from a
seed (float64, rtol and atol 1e-12 unless stated): the rotation helpers, the
renormalised Euler step, RK4, `rollout(method=)`, the mixer (also against
the tick's second form of it, and the steps against the NumPy oracle),
`rotate_z`, `gate_move` on the same noise, the pretrain label, and the
random gate and general scenario on the JAX package's own raw draws.  The
samplers' draws are PyTorch's, so their ranges and moments are checked as
tests/test_training.py::TestSamplers checks the JAX ones.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.core import rotations as jrot
from learningagileflight_se3_tpu.dynamics import quadrotor as jdyn
from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.models import sampler as jsampler
from learningagileflight_se3_tpu.oracle.numpy_reference import np_euler_step, np_rollout

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.core import rotations as trot
from learningagileflight_se3_torch.dynamics import quadrotor as tdyn
from learningagileflight_se3_torch.geometry import gate as tgate
from learningagileflight_se3_torch.models import mlp as tmlp
from learningagileflight_se3_torch.models import sampler as tsampler
from learningagileflight_se3_torch.sim import external_controller as tctl

TIGHT = dict(rtol=1e-12, atol=1e-12)
PQ_J, PQ_T = jcfg.QuadParams(), tcfg.QuadParams()
v = jax.vmap


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(a, b, **kw):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(kw or TIGHT))


def _states(r, n):
    x = r.normal(size=(n, 13))
    q = r.normal(size=(n, 4)) * 0.4
    q[:, 0] += 1.0
    x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return x


# ------------------------------------------------------------- rotations
def test_rotation_helpers_match_jax(rng):
    n = 40
    a, b = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    p, q = rng.normal(size=(n, 4)), rng.normal(size=(n, 4))
    close(trot.normalize(t64(a)), v(jrot.normalize)(a))
    close(trot.normalize(t64(a), eps=1e-3), v(lambda x: jrot.normalize(x, 1e-3))(a))
    close(trot.skew(t64(a)), v(jrot.skew)(a))
    close((trot.skew(t64(a)) @ t64(b)[..., None])[..., 0], np.cross(a, b))
    close(trot.quat_to_dcm_b2w(t64(q)), v(jrot.quat_to_dcm_b2w)(q))
    close(trot.quat_mul(t64(p), t64(q)), v(jrot.quat_mul)(p, q))
    close(trot.quat_conj(t64(q)), v(jrot.quat_conj)(q))
    theta, axis = trot.rodrigues_to_axis_angle(t64(a))
    theta_j, axis_j = v(jrot.rodrigues_to_axis_angle)(a)
    close(theta, theta_j)
    close(axis, axis_j)


def test_rodrigues_to_axis_angle_at_zero_rotation():
    """The 1e-8 x offset decides the axis at w = 0 in both."""
    theta, axis = trot.rodrigues_to_axis_angle(torch.zeros(3, dtype=torch.float64))
    theta_j, axis_j = jrot.rodrigues_to_axis_angle(jnp.zeros(3))
    assert float(theta) == float(theta_j) == 0.0
    close(axis, axis_j)
    close(axis, [1.0, 0.0, 0.0])


def test_unbatched_calls_match_batched(rng):
    """One quaternion / vector gives the batch's row."""
    a, p, q = rng.normal(size=(4, 3)), rng.normal(size=(4, 4)), rng.normal(size=(4, 4))
    close(trot.skew(t64(a[2])), trot.skew(t64(a))[2])
    close(trot.quat_mul(t64(p[1]), t64(q[1])), trot.quat_mul(t64(p), t64(q))[1])
    close(trot.normalize(t64(a[3])), trot.normalize(t64(a))[3])


# -------------------------------------------------------------- dynamics
def test_plant_steps_match_jax_and_the_numpy_oracle(rng):
    n = 24
    x, u = _states(rng, n), rng.uniform(0.0, 2.44, size=(n, 4))
    xt, ut = t64(x), t64(u)
    close(tdyn.euler_step_renorm(xt, ut, 0.01, PQ_T),
          v(lambda a, b: jdyn.euler_step_renorm(a, b, 0.01, PQ_J))(x, u))
    close(tdyn.rk4_step(xt, ut, 0.1, PQ_T), v(lambda a, b: jdyn.rk4_step(a, b, 0.1, PQ_J))(x, u))
    close(tdyn.rk4_step(xt, ut, 0.1, PQ_T, substeps=2),
          v(lambda a, b: jdyn.rk4_step(a, b, 0.1, PQ_J, substeps=2))(x, u))
    oracle = np.stack([np_euler_step(a, b, 0.01, PQ_J) for a, b in zip(x, u)])
    close(tdyn.euler_step(xt, ut, 0.01, PQ_T), oracle)
    renorm = oracle.copy()
    renorm[:, 6:10] /= np.linalg.norm(renorm[:, 6:10], axis=1, keepdims=True)
    got = tdyn.euler_step_renorm(xt, ut, 0.01, PQ_T)
    close(got, renorm)
    close(torch.linalg.vector_norm(got[:, 6:10], dim=1), np.ones(n))


def test_euler_step_renorm_guards_a_zero_quaternion():
    x = np.zeros(13)
    u = np.zeros(4)
    got = tdyn.euler_step_renorm(t64(x), t64(u), 0.01, PQ_T)
    want = jdyn.euler_step_renorm(jnp.asarray(x), jnp.asarray(u), 0.01, PQ_J)
    assert torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_rollout_methods_match_jax(rng, method):
    B, H = 5, 9
    x0, U = _states(rng, B), rng.uniform(0.0, 2.44, size=(B, H, 4))
    got = tdyn.rollout(t64(x0), t64(U), 0.1, PQ_T, method=method)
    close(got, v(lambda a, b: jdyn.rollout(a, b, 0.1, PQ_J, method=method))(x0, U))
    assert got.shape == (B, H + 1, 13)
    if method == "euler":
        close(got, np.stack([np_rollout(a, b, 0.1, PQ_J) for a, b in zip(x0, U)]))
        close(tdyn.rollout(t64(x0), t64(U), 0.1, PQ_T), got, rtol=0, atol=0)


def test_mixer_matches_jax_and_the_tick_form(rng):
    """mixer_matrix / thrust_torque against JAX, and against the second form
    of the mixer the deployment tick keeps (diag([1, -l/2, l/2, -c]) @ A)."""
    u = rng.uniform(0.0, 2.44, size=(16, 4))
    close(tdyn.mixer_matrix(PQ_T), jdyn.mixer_matrix(PQ_J))
    assert tdyn.mixer_matrix(PQ_T, dtype=torch.float32).dtype == torch.float32
    close(tdyn.thrust_torque(t64(u), PQ_T), v(lambda a: jdyn.thrust_torque(a, PQ_J))(u))
    tick_mix = np.diag([1.0, -PQ_T.l / 2, PQ_T.l / 2, -PQ_T.c]) @ tctl._A
    close(tdyn.mixer_matrix(PQ_T), tick_mix)
    close(tdyn.thrust_torque(t64(u), PQ_T), u @ tick_mix.T)


# ------------------------------------------------------------------ gate
def _gates(r, n):
    w, pitch = r.uniform(0.6, 1.6, size=n), r.uniform(-1.2, 1.2, size=n)
    pts = np.asarray(v(jgate.gate_from_width)(jnp.asarray(w), jnp.asarray(pitch)))
    return pts + r.normal(size=(n, 1, 3)) * 2.0


def test_rotate_z_matches_jax(rng):
    pts, ang = _gates(rng, 32), rng.normal(size=32)
    close(tgate.rotate_z(t64(pts), t64(ang)), v(jgate.rotate_z)(pts, ang))
    close(tgate.rotate_z(t64(pts[0]), t64(ang[0])), jgate.rotate_z(pts[0], ang[0]))


def _jax_gate_noise(key, n, std, clip):
    """The clipped velocity noise gate_move draws from `key`."""
    return np.asarray(jnp.clip(std * jax.random.normal(key, (n, 3), dtype=jnp.float64), -clip, clip))


@pytest.mark.parametrize("std,clip,T", [(0.1, 0.1, 5.0), (0.05, 0.2, 1.2), (0.0, 0.1, 0.4)])
def test_gate_move_on_the_same_noise_matches_jax(rng, std, clip, T):
    """The 500-step recursion (rotate about the current centroid, then
    translate) on the JAX package's noise, one gate and a batch."""
    B = 3
    pts = _gates(rng, B)
    velo, w = np.array([1.0, 0.3, 0.4]), np.pi / 2
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    n = int(T / 0.01)
    noise = np.stack([_jax_gate_noise(k, n, std, clip) for k in keys])
    want = [jgate.gate_move(jnp.asarray(p), k, velo, w, T=T, dt=0.01, noise_std=std, noise_clip=clip)
            for p, k in zip(pts, keys)]
    moves, V = tgate.gate_move(t64(pts), None, velo, w, T=T, dt=0.01, noise_std=std,
                               noise_clip=clip, noise=t64(noise))
    assert moves.shape == (B, n + 1, 4, 3) and V.shape == (B, n + 1, 3)
    close(moves, np.stack([np.asarray(m) for m, _ in want]), rtol=1e-12, atol=1e-11)
    close(V, np.stack([np.asarray(vv) for _, vv in want]))
    one_m, one_v = tgate.gate_move(t64(pts[1]), None, velo, w, T=T, dt=0.01, noise=t64(noise[1]))
    close(one_m, moves[1], rtol=0, atol=0)
    close(one_v, V[1], rtol=0, atol=0)


def test_gate_move_draws_clipped_noise_from_the_generator():
    pts = t64(_gates(np.random.default_rng(1), 6))
    g = torch.Generator().manual_seed(3)
    moves, V = tgate.gate_move(pts, g, (1.0, 0.3, 0.4), 1.0, T=2.0, dt=0.01, noise_std=0.1,
                               noise_clip=0.1)
    eps = V[:, 1:] - torch.tensor([1.0, 0.3, 0.4], dtype=torch.float64)
    assert moves.shape == (6, 201, 4, 3) and float(eps.abs().max()) <= 0.1 + 1e-12
    # sigma = clip: about 32% of the draws sit on the clip
    on_clip = float((eps.abs() > 0.1 - 1e-9).double().mean())
    assert 0.25 < on_clip < 0.39 and abs(float(eps.mean())) < 0.01
    again, _ = tgate.gate_move(pts, torch.Generator().manual_seed(3), (1.0, 0.3, 0.4), 1.0,
                               T=2.0, dt=0.01)
    close(again, moves, rtol=0, atol=0)


def test_gate_pitch_across_the_wrap_matches_jax():
    """atan of a ratio whose denominator crosses zero as the gate turns: the
    same values either side, the same signed infinity handling at it."""
    pitch = np.concatenate([np.linspace(1.4, 1.75, 36), [np.pi / 2, -np.pi / 2, 0.0]])
    pts = np.asarray(v(jgate.gate_from_width)(jnp.full(pitch.shape, 1.0), jnp.asarray(pitch)))
    close(tgate.gate_pitch(t64(pts)), v(jgate.gate_pitch)(pts))
    vertical = np.array([[0.0, 0, 1], [0.0, 0, -1], [0.0, 0, -1], [0.0, 0, 1]])
    for sign in (1.0, -1.0):
        got = float(tgate.gate_pitch(t64(sign * vertical)))
        assert got == float(jgate.gate_pitch(jnp.asarray(sign * vertical))) == sign * np.pi / 2


# --------------------------------------------------------------- sampler
def test_pretrain_label_matches_jax(rng):
    scen = rng.normal(size=(200, 9)) * 4.0
    # ties of the rounding to 0.1 s: |r|/4*10 exactly half way
    scen[0, 0:3], scen[1, 0:3], scen[2, 0:3] = [9.0, 0, 0], [0, -9.8, 0], [0, 0, 80.0]
    got = tsampler.pretrain_label(t64(scen))
    close(got, v(jsampler.pretrain_label)(scen))
    assert got.shape == (200, 7) and float(got[:, :6].abs().max()) == 0.0
    assert float(got[0, 6]) == 2.2 and float(got[2, 6]) == 4.0  # 2.25 rounds to even
    close(tsampler.pretrain_label(t64(scen[5])), got[5], rtol=0, atol=0)


def _unit_draws(keys, uniforms, normals):
    """The unit uniforms and standard normals behind jax.random's scaled draws
    from the same keys."""
    d = {k: np.asarray(jax.random.uniform(keys[i], shape)) for k, (i, shape) in uniforms.items()}
    d.update({k: np.asarray(jax.random.normal(keys[i], shape)) for k, (i, shape) in normals.items()})
    return d


def test_random_gate_on_the_jax_draws_matches_jax():
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k = jax.random.split(key, 5)
        d = _unit_draws(k, {"dia": (0, ()), "p2z": (2, ()), "p4z": (4, ())},
                        {"p2x": (1, ()), "p4x": (3, ())})
        got = tsampler.random_gate_from_draws({n: t64(a) for n, a in d.items()})
        close(got, jsampler.sample_random_gate(key))


def test_general_scenario_on_the_jax_draws_matches_jax():
    """sample_general_scenario's deterministic placement, from the raw draws
    of the JAX function's own key splits."""
    rows, draws = [], []
    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        k = jax.random.split(key, 12)
        d = _unit_draws(
            k, {"scaling": (0, ()), "phi": (1, ()), "beta": (3, ()), "length": (6, ()), "dist": (11, ())},
            {"theta": (2, ()), "axis": (4, (3,)), "angle": (5, ()), "translation": (7, (3,)),
             "velocity": (9, (3,)), "rd": (10, (3,))})
        d["final"] = np.asarray(jax.random.normal(jax.random.fold_in(k[11], 1), (3,)))
        kg = jax.random.split(k[8], 5)
        d.update(_unit_draws(kg, {"dia": (0, ()), "p2z": (2, ()), "p4z": (4, ())},
                             {"p2x": (1, ()), "p4x": (3, ())}))
        draws.append(d)
        rows.append(np.asarray(jsampler.sample_general_scenario(key)))
        close(tsampler.general_scenario_from_draws({n: t64(a) for n, a in d.items()}), rows[-1],
              rtol=1e-12, atol=1e-11)
    batch = {n: t64(np.stack([d[n] for d in draws])) for n in draws[0]}
    close(tsampler.general_scenario_from_draws(batch), np.stack(rows), rtol=1e-12, atol=1e-11)


def test_rotvec_to_dcm_matches_jax(rng):
    rv = rng.normal(size=(12, 3))
    rv[0] = 0.0
    close(tsampler._rotvec_to_dcm(t64(rv)), v(jsampler._rotvec_to_dcm)(rv))


def test_random_gate_ranges():
    g = tsampler.sample_random_gate(torch.Generator().manual_seed(0), 500, dtype=torch.float64).numpy()
    assert g.shape == (500, 4, 3)
    np.testing.assert_allclose(g[:, 0], 0.0)
    assert np.all(g[:, 2, 0] >= 1.5) and np.all(g[:, 2, 0] <= 3.0)
    np.testing.assert_allclose(g[:, :, 1], 0.0, atol=1e-12)
    assert np.all(g[:, 1, 2] >= 0) and np.all(g[:, 3, 2] <= 0)
    assert np.all(g[:, 1, 2] <= g[:, 2, 0]) and np.all(g[:, 3, 2] >= -g[:, 2, 0])
    assert tsampler.sample_random_gate(torch.Generator().manual_seed(0)).shape == (4, 3)


def test_general_scenario_ranges_and_moments():
    s = tsampler.sample_general_scenario(torch.Generator().manual_seed(1), 4000,
                                         dtype=torch.float64).numpy()
    assert s.shape == (4000, 25)
    r = np.linalg.norm(s[:, 0:3], axis=-1)
    assert r.min() >= 3.0 - 1e-9 and r.max() <= 16.0 + 1e-9
    assert abs(r.mean() - 9.5) < 0.3                       # U(3, 16)
    assert np.all(np.abs(s[:, 2]) <= r / np.sqrt(2) + 1e-9)  # theta in [pi/4, 3pi/4]
    np.testing.assert_allclose(np.linalg.norm(s[:, 18:22], axis=-1), 1.0, atol=1e-12)
    gate = s[:, 3:15].reshape(-1, 4, 3)
    dia = np.linalg.norm(gate[:, 2] - gate[:, 0], axis=-1)
    assert dia.min() >= 1.5 - 1e-9 and dia.max() <= 3.0 + 1e-9
    assert abs(s[:, 15:18].std() - 3.0) < 0.1              # velocity ~ 3 N(0,1)
    assert tsampler.sample_general_scenario(torch.Generator().manual_seed(1)).shape == (25,)


# ------------------------------------------------------------------- MLP
@pytest.mark.parametrize("name,n_in,hidden", [("make_dnn1", 9, 64), ("make_dnn2", 18, 128)])
def test_seeded_init_is_reproducible_and_in_the_linear_bounds(name, n_in, hidden):
    make = getattr(tmlp, name)
    a = make(generator=torch.Generator().manual_seed(5))
    b = make(generator=torch.Generator().manual_seed(5))
    c = make(generator=torch.Generator().manual_seed(6))
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(p, q) and not torch.equal(p, r), n
    for layer, fan_in in zip(a.layers, (n_in, hidden, hidden)):
        bound = 1.0 / np.sqrt(fan_in)
        for p in (layer.weight, layer.bias):
            assert float(p.detach().abs().max()) <= bound
        # U(-b, b): mean 0, standard deviation b / sqrt(3)
        w = layer.weight.detach().double()
        assert abs(float(w.mean())) < 0.1 * bound and abs(float(w.std()) * np.sqrt(3) / bound - 1) < 0.1
    # the global generator is not consumed
    state = torch.get_rng_state()
    make(generator=torch.Generator().manual_seed(7))
    assert torch.equal(state, torch.get_rng_state())
