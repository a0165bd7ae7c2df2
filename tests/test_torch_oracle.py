"""The port's independent yardsticks (`learningagileflight_se3_torch/oracle/`)
against the JAX package's, on the same inputs in float64 on the CPU.

  * the numpy plant and cost, bit for bit;
  * the shooting objective's value and gradient (torch.autograd through the
    adjoint) against jax.value_and_grad, and the shooting oracle's first
    L-BFGS-B iterations;
  * the lifted-NLP oracle (`method="auto"`) on the canonical problem of
    tests/test_oracle_lifted.py at H=15, t=1.0: both reach KKT < 1e-6 and
    defect < 1e-8, and land on the same point (scripts/compare_oracles.py
    prints how close: a few ulp);
  * (tests/test_torch_oracle_methods.py: the other methods and inits);
  * the port's plain-path solver against the port's oracle, the mirror of
    test_oracle_lifted.py's test_h15_cold_basin_and_mae (and, `slow`, its
    H=50 flagship).

L-BFGS-B on this stiff objective is chaotic in its last digits: two
implementations whose gradients agree to rounding part within a few
iterations and stall short of the optimum at different points.  So the
shooting oracle is held to the JAX one on the objective itself and on its
first 5 iterations; the polished lifted oracle is held to 1e-6 in the
controls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.core.rotations import rodrigues_to_quat as j_rodrigues
from learningagileflight_se3_tpu.costs.gate_costs import total_trajectory_cost as j_total_cost
from learningagileflight_se3_tpu.dynamics.quadrotor import rollout as j_rollout
from learningagileflight_se3_tpu.oracle import numpy_reference as j_np
from learningagileflight_se3_tpu.oracle import solve_lifted_oracle as j_lifted
from learningagileflight_se3_tpu.oracle import solve_shooting_oracle as j_shooting

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.oracle import numpy_reference as t_np
from learningagileflight_se3_torch.oracle import solve_lifted_oracle, solve_shooting_oracle
from learningagileflight_se3_torch.oracle.shooting import make_shooting_objective
from learningagileflight_se3_torch.solver.ilqr import make_mpc_solver

try:  # scipy's L-BFGS-B spins idle BLAS threads; keep the xdist workers apart
    from threadpoolctl import threadpool_limits
except ImportError:  # pragma: no cover
    threadpool_limits = None


@pytest.fixture(autouse=True)
def _one_blas_thread():
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(1, user_api="blas"):
            yield


def canonical_args(t=1.0):
    """tests/test_oracle_lifted.py's canonical problem (its initial attitude
    is the identity: a zero angle about [3, 3, 5])."""
    x0 = np.zeros(13)
    x0[0:3] = [0.0, -8.0, 0.0]
    x0[6] = 1.0
    return (x0, np.zeros(4), np.array([0.0, 8.0, 0.0]), np.zeros(3), np.array([0.0, 0.6, 0.0]), t)


def configs(H, **kw):
    kw = {"horizon": H, "max_iters": 300, "w_bound": float("inf"), **kw}
    return jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw)


@pytest.fixture(scope="module")
def lifted_h15():
    """Both packages' lifted oracles (method="auto") on the canonical
    problem at H=15, t=1.0, and the JAX record of the problem."""
    j_cfg, t_cfg = configs(15)
    args = canonical_args()
    ref = j_lifted(jcfg.QuadParams(), jcfg.CostWeights(), j_cfg, *args)
    got = solve_lifted_oracle(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, *args)
    return ref, got, t_cfg, args


def test_numpy_reference_bit_for_bit(rng):
    p_j, p_t = jcfg.QuadParams(), tcfg.QuadParams()
    for _ in range(5):
        x = rng.normal(size=13)
        x[6:10] /= np.linalg.norm(x[6:10])
        u = rng.uniform(0.0, 2.44, size=4)
        np.testing.assert_array_equal(t_np.np_quad_ode(x, u, p_t), j_np.np_quad_ode(x, u, p_j))
        np.testing.assert_array_equal(t_np.np_euler_step(x, u, 0.1, p_t), j_np.np_euler_step(x, u, 0.1, p_j))
    x0, _, goal, tra_pos, tra_ang, _ = canonical_args()
    U = rng.uniform(0.8, 1.6, size=(12, 4))
    X_t, X_j = t_np.np_rollout(x0, U, 0.1, p_t), j_np.np_rollout(x0, U, 0.1, p_j)
    np.testing.assert_array_equal(X_t, X_j)
    q = np.asarray(j_rodrigues(jnp.asarray(tra_ang)))
    for squared, wqf in ((True, 0.0), (False, 2.0)):
        w_t = tcfg.CostWeights(squared_attitude=squared, wqf=wqf)
        w_j = jcfg.CostWeights(squared_attitude=squared, wqf=wqf)
        assert t_np.np_total_cost(X_t, U, np.ones(4), 0.1, 0.7, goal, tra_pos, q, w_t) == \
            j_np.np_total_cost(X_j, U, np.ones(4), 0.1, 0.7, goal, tra_pos, q, w_j)


def test_shooting_objective_matches_jax(rng):
    """Value and gradient of the shooting objective at seeded controls,
    with and without the soft omega-box penalty."""
    H = 15
    x0, u_last, goal, tra_pos, tra_ang, t = canonical_args()
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    for w_bound_weight in (0.0, 10.0):
        j_cfg, t_cfg = configs(H, w_bound=1.0, w_bound_weight=w_bound_weight) if w_bound_weight \
            else configs(H)
        fun = make_shooting_objective(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, f64(x0), f64(u_last),
                                      f64(goal), f64(tra_pos), rodrigues_to_quat(f64(tra_ang)), t)

        def j_obj(U_flat):
            U = U_flat.reshape(H, 4)
            X = j_rollout(jnp.asarray(x0), U, 0.1, jcfg.QuadParams())
            c = j_total_cost(X, U, jnp.asarray(u_last), 0.1, t, jnp.asarray(goal), jnp.asarray(tra_pos),
                             j_rodrigues(jnp.asarray(tra_ang)), jcfg.CostWeights())
            viol = jnp.maximum(jnp.abs(X[:-1, 10:13]) - j_cfg.w_bound, 0.0)
            return c + j_cfg.w_bound_weight * jnp.sum(viol**2)

        j_vg = jax.jit(jax.value_and_grad(j_obj))
        for lo, hi in ((1.0, 1.5), (0.0, 2.44)):
            U = rng.uniform(lo, hi, size=H * 4)
            v, g = fun(U)
            v_ref, g_ref = j_vg(jnp.asarray(U))
            assert abs(v - float(v_ref)) <= 1e-12 * abs(float(v_ref))
            g_ref = np.asarray(g_ref)
            assert np.abs(g - g_ref).max() <= 1e-11 * np.abs(g_ref).max()


def test_shooting_oracle_matches_jax():
    """Five L-BFGS-B iterations from the midpoint and the hover start on
    the canonical problem, within the rounding's spread on this stiff
    objective after five line searches."""
    j_cfg, t_cfg = configs(15)
    args = canonical_args()
    for U_init in (None, np.full((15, 4), 0.5 * 9.78 / 4)):
        X_j, U_j, c_j, r_j = j_shooting(jcfg.QuadParams(), jcfg.CostWeights(), j_cfg, *args,
                                        U_init=U_init, maxiter=5)
        X_t, U_t, c_t, r_t = solve_shooting_oracle(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, *args,
                                                   U_init=U_init, maxiter=5)
        assert r_t.nit == r_j.nit == 5
        assert np.abs(U_t - U_j).max() < 1e-5
        assert abs(c_t - c_j) <= 1e-7 * abs(c_j)
        np.testing.assert_allclose(X_t, np.asarray(X_j), rtol=0, atol=1e-4)


def test_lifted_oracle_matches_jax(lifted_h15):
    ref, got, _, _ = lifted_h15
    for sol in (ref, got):
        assert sol.kkt_residual < 1e-6, "oracle did not converge"
        assert sol.constr_violation < 1e-8
    assert np.abs(got.control_traj - ref.control_traj).max() < 1e-6
    assert abs(got.cost - ref.cost) <= 1e-9 * abs(ref.cost)
    np.testing.assert_allclose(got.state_traj, ref.state_traj, rtol=0, atol=1e-6)


def test_h15_cold_basin_and_mae(lifted_h15):
    """The port's plain-path solver, cold from the midpoint, lands on the
    port oracle's optimum (tests/test_oracle_lifted.py's gates)."""
    _, lifted, t_cfg, args = lifted_h15
    solve = make_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, return_gains=False, device="cpu")
    sol = solve(*[torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in args])
    mae = np.mean(np.abs(lifted.control_traj - sol.control_traj.numpy()))
    assert mae < 1e-3, f"cold-start control MAE {mae}"
    rel = abs(lifted.cost - float(sol.cost)) / abs(lifted.cost)
    assert rel < 1e-6, f"cold-start cost gap {rel}"


@pytest.mark.slow
def test_flagship_h50_cold_basin_and_mae():
    """The H=50 flagship of tests/test_oracle_lifted.py on the port: the
    plain-path solver against the port's oracle."""
    _, t_cfg = configs(50)
    args = canonical_args(t=3.0)
    sol = make_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, return_gains=False, device="cpu")(
        *[torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in args])
    lifted = solve_lifted_oracle(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, *args, maxiter=8000)
    assert bool(sol.converged)
    assert lifted.kkt_residual < 1e-6
    assert lifted.constr_violation < 1e-8
    mae = np.mean(np.abs(lifted.control_traj - sol.control_traj.numpy()))
    assert mae < 1e-3, f"cold-start control MAE {mae}"
    rel = abs(lifted.cost - float(sol.cost)) / abs(lifted.cost)
    assert rel < 1e-6, f"cold-start cost gap {rel}"
