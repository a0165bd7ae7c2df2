"""The port's lifted-NLP oracle's other methods and inits
(`method="newton" | "trust-constr" | "al"`, `init="zeros" | "rollout"`)
against the JAX package's, on tests/test_oracle_lifted.py's canonical
problem cut to H=5, t=0.3, in float64 on the CPU.  The `auto` cascade, the
shooting oracle and the numpy plant are in tests/test_torch_oracle.py.
"""

import numpy as np
import pytest

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.oracle import solve_lifted_oracle as j_lifted

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.oracle import solve_lifted_oracle

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


def problem():
    x0 = np.zeros(13)
    x0[0:3] = [0.0, -8.0, 0.0]
    x0[6] = 1.0
    args = (x0, np.zeros(4), np.array([0.0, 8.0, 0.0]), np.zeros(3), np.array([0.0, 0.6, 0.0]), 0.3)
    kw = {"horizon": 5, "max_iters": 300, "w_bound": float("inf")}
    return jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw), args


@pytest.mark.parametrize("method,init,maxiter,polish", [
    ("newton", "zeros", 100, True),
    ("trust-constr", "zeros", 100, True),
    ("trust-constr", "rollout", 5, False),
])
def test_lifted_methods_match_jax(method, init, maxiter, polish):
    """Each method and init, compared where it is deterministic: polished
    to its end, or before the iterations' rounding spreads."""
    j_cfg, t_cfg, args = problem()
    kw = dict(maxiter=maxiter, method=method, init=init, polish=polish)
    ref = j_lifted(jcfg.QuadParams(), jcfg.CostWeights(), j_cfg, *args, **kw)
    got = solve_lifted_oracle(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, *args, **kw)
    assert np.abs(got.control_traj - ref.control_traj).max() < 1e-9
    np.testing.assert_allclose(got.state_traj, ref.state_traj, rtol=0, atol=1e-9)
    assert abs(got.cost - ref.cost) <= 1e-12 * abs(ref.cost)
    if polish:
        assert abs(got.kkt_residual - ref.kkt_residual) <= 1e-6 * max(1.0, ref.kkt_residual)


def test_lifted_augmented_lagrangian_matches_jax():
    """method="al": one outer iteration of 400 inner L-BFGS-B steps, which
    spread as the shooting oracle's do, so the gates are looser."""
    j_cfg, t_cfg, args = problem()
    kw = dict(maxiter=100, method="al", init="rollout", polish=False)
    ref = j_lifted(jcfg.QuadParams(), jcfg.CostWeights(), j_cfg, *args, **kw)
    got = solve_lifted_oracle(tcfg.QuadParams(), tcfg.CostWeights(), t_cfg, *args, **kw)
    assert abs(got.cost - ref.cost) <= 1e-6 * abs(ref.cost)
    assert abs(got.constr_violation - ref.constr_violation) <= 1e-5
