"""PyTorch port, lowest layers: configs, rotations, dynamics, costs, chol4,
boxQP and the closed-form derivatives, held against the JAX package on the
same numpy inputs (float64: atol 1e-12, rtol 1e-10), and the closed forms
also against torch.autograd.functional."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.core import rotations as jrot
from learningagileflight_se3_tpu.costs import gate_costs as jcost
from learningagileflight_se3_tpu.dynamics import quadrotor as jdyn
from learningagileflight_se3_tpu.solver import analytic as jana
from learningagileflight_se3_tpu.solver.boxqp import boxqp as jboxqp
from learningagileflight_se3_tpu.solver.chol4 import chol4_factor as jchol4_factor
from learningagileflight_se3_tpu.solver.chol4 import chol4_solve as jchol4_solve

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.core import rotations as trot
from learningagileflight_se3_torch.costs import gate_costs as tcost
from learningagileflight_se3_torch.dynamics import quadrotor as tdyn
from learningagileflight_se3_torch.solver import analytic as tana
from learningagileflight_se3_torch.solver.boxqp import boxqp as tboxqp
from learningagileflight_se3_torch.solver.chol4 import chol4_factor, chol4_solve

TOL = dict(atol=1e-12, rtol=1e-10)
N = 64


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def quats(r, n=N, s=0.4):
    q = r.normal(size=(n, 4)) * s
    q[:, 0] += 1.0
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def states(r, n=N):
    x = r.normal(size=(n, 13))
    x[:, 6:10] = quats(r, n)
    return x


# ------------------------------------------------------------------ configs
CONFIG_CLASSES = ["QuadParams", "CostWeights", "SolverConfig", "RewardConfig",
                  "SamplerConfig", "GateMotionConfig", "LearnedGradConfig"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf


@pytest.mark.parametrize("variant", ["MAIN", "PYBULLET"])
def test_preset_equal(variant):
    jp = jcfg.preset(getattr(jcfg.Variant, variant))
    tp = tcfg.preset(getattr(tcfg.Variant, variant))
    assert [dataclasses.asdict(c) for c in jp] == [dataclasses.asdict(c) for c in tp]


# ---------------------------------------------------------------- rotations
def test_quat_to_dcm_and_omega(rng):
    q = rng.normal(size=(N, 4))  # not normalized: the DCM formula is used as is
    close(trot.quat_to_dcm_w2b(t64(q)), jax.vmap(jrot.quat_to_dcm_w2b)(jnp.asarray(q)))
    w = rng.normal(size=(N, 3))
    close(trot.omega_matrix(t64(w)), jax.vmap(jrot.omega_matrix)(jnp.asarray(w)))


def test_axis_angle_and_rodrigues(rng):
    ang, ax = rng.normal(size=N), rng.normal(size=(N, 3))
    close(trot.axis_angle_to_quat(t64(ang), t64(ax)),
          jax.vmap(jrot.axis_angle_to_quat)(jnp.asarray(ang), jnp.asarray(ax)))
    w = rng.normal(size=(N, 3))
    w[0] = 0.0
    close(trot.rodrigues_to_quat(t64(w)), jax.vmap(jrot.rodrigues_to_quat)(jnp.asarray(w)))


def test_dcm_to_quat_all_branches(rng):
    # rotations by ~pi about each axis drive each of the four candidates
    q = quats(rng, s=0.3)
    q[: N // 4] = quats(rng, N // 4, s=0.05)[:, [1, 0, 2, 3]]
    q[N // 4: N // 2] = quats(rng, N // 4, s=0.05)[:, [1, 2, 0, 3]]
    q[N // 2: 3 * N // 4] = quats(rng, N // 4, s=0.05)[:, [1, 2, 3, 0]]
    q[-1] = -q[-1]
    R = np.asarray(jax.vmap(lambda a: jrot.quat_to_dcm_w2b(a).T)(jnp.asarray(q)))
    close(trot.dcm_to_quat(t64(R)), jax.vmap(jrot.dcm_to_quat)(jnp.asarray(R)))


# ----------------------------------------------------------------- dynamics
def test_quad_ode_and_euler_step(rng):
    P, tP = jcfg.QuadParams(), tcfg.QuadParams()
    x, u = states(rng), rng.uniform(0, 2.44, size=(N, 4))
    close(tdyn.quad_ode(t64(x), t64(u), tP),
          jax.vmap(lambda a, b: jdyn.quad_ode(a, b, P))(jnp.asarray(x), jnp.asarray(u)))
    close(tdyn.euler_step(t64(x), t64(u), 0.1, tP),
          jax.vmap(lambda a, b: jdyn.euler_step(a, b, 0.1, P))(jnp.asarray(x), jnp.asarray(u)))


# -------------------------------------------------------------------- costs
@pytest.mark.parametrize("squared,wqf", [(True, 0.0), (False, 0.0), (True, 2.0)])
def test_costs(rng, squared, wqf):
    W = jcfg.CostWeights(squared_attitude=squared, wqf=wqf)
    tW = tcfg.CostWeights(squared_attitude=squared, wqf=wqf)
    x, q, g, tp = states(rng), quats(rng), rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    u = rng.uniform(0, 2.44, size=(N, 4))
    J = lambda f, *a: jax.vmap(f)(*[jnp.asarray(v) for v in a])
    close(tcost.attitude_error(t64(x[:, 6:10]), t64(q)),
          J(jcost.attitude_error, x[:, 6:10], q))
    close(tcost.goal_cost(t64(x), t64(g), tW), J(lambda a, b: jcost.goal_cost(a, b, W), x, g))
    close(tcost.traversal_cost(t64(x), t64(tp), t64(q), tW),
          J(lambda a, b, c: jcost.traversal_cost(a, b, c, W), x, tp, q))
    close(tcost.thrust_cost(t64(u), tW), J(lambda a: jcost.thrust_cost(a, W), u))
    close(tcost.final_cost(t64(x), t64(g), tW), J(lambda a, b: jcost.final_cost(a, b, W), x, g))
    k, t = np.arange(N, dtype=np.float64) % 50, rng.uniform(1, 4, size=N)
    close(tcost.traversal_weight(t64(k), 0.1, t64(t), tW),
          jcost.traversal_weight(jnp.asarray(k), 0.1, jnp.asarray(t), W))


# ------------------------------------------------------------ chol4 / boxQP
def _spd(rng, n=N):
    A = rng.normal(size=(n, 4, 4))
    return A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(4)


def test_chol4_against_jax(rng):
    M, b = _spd(rng), rng.normal(size=(N, 4))
    M[0] = -np.eye(4)  # not positive definite: ok must be False
    X, ok = chol4_solve(t64(M).permute(1, 2, 0), t64(b).T)
    jX, jok = jax.vmap(jchol4_solve)(jnp.asarray(M), jnp.asarray(b))
    close(X.T[1:], np.asarray(jX)[1:])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jax.vmap(lambda m: jchol4_factor(m)[1])(jnp.asarray(M))))
    assert not ok[0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chol4_tolerance_follows_dtype(dtype):
    # pivot 1e-9: above the f64 tol (1e-12), below the f32 one (1e-7)
    M = torch.eye(4, dtype=dtype)[..., None].clone()
    M[3, 3] = 1e-9
    _, ok = chol4_factor(M)
    assert bool(ok[0]) == (dtype == torch.float64)


def test_boxqp_against_jax(rng):
    H, g = _spd(rng), rng.normal(size=(N, 4)) * 3
    lo, hi = -rng.uniform(0, 1, size=(N, 4)), rng.uniform(0, 1, size=(N, 4))
    d, free = tboxqp(t64(H).permute(1, 2, 0), t64(g).T, t64(lo).T, t64(hi).T, iters=6)
    jd, jfree = jax.vmap(jboxqp)(*[jnp.asarray(a) for a in (H, g, lo, hi)])
    close(d.T, jd)
    np.testing.assert_array_equal(free.T.numpy(), np.asarray(jfree))
    assert 0 < free.mean() < 1  # both clamped and free coordinates occur


# ------------------------------------------------------------------ analytic
def _zu(rng, n=N):
    zu = np.concatenate([states(rng, n), rng.uniform(0, 2.44, size=(n, 8))], axis=1)
    zu[:, 10:13] *= 2.0  # some |omega| beyond the pi/2 bound
    return zu


def test_attitude_curvature_and_offset(rng):
    q = quats(rng)
    close(tana.attitude_curvature(t64(q)), jax.vmap(jana.attitude_curvature)(jnp.asarray(q)))
    close(tana.attitude_offset(t64(q)),
          3.0 - jnp.trace(jax.vmap(jrot.quat_to_dcm_w2b)(jnp.asarray(q)), axis1=1, axis2=2))


@pytest.mark.parametrize("squared,wqf,wbw", [(True, 0.0, 0.0), (False, 0.0, 0.0),
                                             (True, 2.0, 3.0)])
def test_cost_quadratics_against_jax(rng, squared, wqf, wbw):
    H = 8
    W = jcfg.CostWeights(squared_attitude=squared, wqf=wqf)
    C = jcfg.SolverConfig(horizon=H, w_bound_weight=wbw)
    tW = tcfg.CostWeights(squared_attitude=squared, wqf=wqf)
    tC = tcfg.SolverConfig(horizon=H, w_bound_weight=wbw)
    zu = _zu(rng, H)
    tw, g, tp, tq = rng.uniform(0, 60, size=H), rng.normal(size=3), rng.normal(size=3), quats(rng, 1)[0]
    ref = jana.make_cost_quadratics(W, C)(*[jnp.asarray(a) for a in (zu[:, :17], zu[:, 17:], tw, g, tp, tq)])
    out = tana.make_cost_quadratics(tW, tC)(*[t64(a) for a in (zu[:, :17], zu[:, 17:], tw, g, tp, tq)])
    for a, b in zip(out, ref):
        close(a, b)
    pz, pzz = tana.make_final_quadratics(tW)(t64(zu[0, :17]), t64(g))
    jpz, jpzz = jana.make_final_quadratics(W)(jnp.asarray(zu[0, :17]), jnp.asarray(g))
    close(pz, jpz)
    close(pzz, jpzz)


def test_explicit_jacobians_and_h2_against_jax(rng):
    P, tP = jcfg.QuadParams(), tcfg.QuadParams()
    zu, lam = _zu(rng), rng.normal(size=(N, 17))
    A, B = tana.explicit_jacobians(t64(zu), tP, 0.1)
    jA, jB = jana.explicit_jacobians(jnp.asarray(zu), P, 0.1)
    close(A, jA)
    close(B, jB)
    close(tana.explicit_h2(t64(zu), t64(lam), tP, 0.1),
          jax.vmap(lambda a, b: jana.explicit_h2(a, b, P, 0.1))(jnp.asarray(zu), jnp.asarray(lam)))


# --------------------------------------- closed forms against torch autograd
def _aug_f(zu, P):
    return torch.cat([tdyn.euler_step(zu[:13], zu[17:], 0.1, P), zu[17:]])


def test_jacobians_and_h2_against_autograd(rng):
    P = tcfg.QuadParams()
    zu, lam = t64(_zu(rng, 1)[0]), t64(rng.normal(size=17))
    F = torch.autograd.functional.jacobian(lambda v: _aug_f(v, P), zu)
    A, B = tana.explicit_jacobians(zu, P, 0.1)
    close(A, F[:, :17], atol=1e-12, rtol=1e-10)
    close(B, F[:, 17:], atol=1e-12, rtol=1e-10)
    H2 = torch.autograd.functional.hessian(lambda v: lam @ _aug_f(v, P), zu)
    close(tana.explicit_h2(zu, lam, P, 0.1), H2, atol=1e-12, rtol=1e-10)


@pytest.mark.parametrize("squared,wqf,wbw", [(True, 0.0, 0.0), (False, 2.0, 3.0)])
def test_cost_quadratics_against_autograd(rng, squared, wqf, wbw):
    W = tcfg.CostWeights(squared_attitude=squared, wqf=wqf)
    C = tcfg.SolverConfig(w_bound_weight=wbw)
    zu = t64(_zu(rng, 1)[0])
    wk, g, tp, tq = 7.0, t64(rng.normal(size=3)), t64(rng.normal(size=3)), t64(quats(rng, 1)[0])

    def stage(v):
        x, up, u = v[:13], v[13:17], v[17:]
        c = (wk * tcost.traversal_cost(x, tp, tq, W) + tcost.goal_cost(x, g, W)
             + tcost.thrust_cost(u, W) + W.w_du * torch.sum((u - up) ** 2))
        if wbw > 0:
            c = c + wbw * torch.sum(torch.clamp_min(x[10:13].abs() - C.w_bound, 0.0) ** 2)
        return c

    grad = torch.autograd.functional.jacobian(stage, zu)
    hess = torch.autograd.functional.hessian(stage, zu)
    lz, lu, lzz, luz, luu = tana.make_cost_quadratics(W, C)(zu[:17], zu[17:], t64(wk), g, tp, tq)
    kw = dict(atol=1e-10, rtol=1e-10)
    close(lz, grad[:17], **kw)
    close(lu, grad[17:], **kw)
    close(lzz, hess[:17, :17], **kw)
    close(luz, hess[17:, :17], **kw)
    close(luu, hess[17:, 17:], **kw)
    Hatt = torch.autograd.functional.hessian(lambda q: tcost.attitude_error(q, tq), zu[6:10])
    close(tana.attitude_curvature(tq), Hatt, atol=1e-12, rtol=1e-10)


# --------------------------------------------------------------- isolation
def test_port_imports_no_jax():
    """Every module of the port imports with JAX made unimportable, as on a
    machine without JAX."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import learningagileflight_se3_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')"
        " and sys.modules[m] is not None]\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 48
