"""PyTorch port, K3 (the backward sweep over precomputed derivatives) and the
split of K2's plain version.

On the CPU, in float64 on tests/test_pallas.py's `_problem_data` inputs
(H=6, B=128): K3's plain version against `riccati_backward_pallas` in
interpret mode, with and without the DDP term (relative error 1e-8, the
measure of tests/test_torch_ops.py, identical `fail` and NaN patterns);
`derivatives_plain` against the JAX closed forms (1e-12), and the closed
forms the VJP of solver/diff.py uses against the JAX package's
DynamicsTaylor contractions (1e-12); K2's plain
version equal to the composition of the two halves and to the JAX
reference sweep on the same derivatives; the wrapper's dispatch and input
checks.  The kernel is held against the plain version on the card by
tests/test_torch_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.ops.riccati_pallas import (
    riccati_backward_pallas,
    riccati_backward_reference,
)

from learningagileflight_se3_tpu.solver.analytic import DynamicsTaylor

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.ops import riccati_fused, riccati_unfused
from learningagileflight_se3_torch.ops.inputs import as_tensors, backward_inputs
from learningagileflight_se3_torch.solver import analytic as tana

from test_pallas import _problem_data

NAMES = ["kk", "KK", "dV1", "dV2", "fail", "pg"]
KW = dict(dt=0.1, lb=0.0, ub=2.44)


def _assert_sweep_close(out, ref, tol=1e-8):
    for name, a, b in zip(NAMES, out, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if name == "fail":
            np.testing.assert_array_equal(a, b)
            continue
        assert (np.isnan(a) == np.isnan(b)).all(), f"{name}: NaN pattern"
        both = np.isfinite(a) & np.isfinite(b)
        rel = np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2), initial=0.0)
        assert rel < tol, f"{name}: rel err {rel}"


@pytest.fixture(scope="module")
def k3_inputs():
    data, reg = _problem_data(np.random.default_rng(0), H=6, B=128, dtype=jnp.float64)
    return [*data, reg]


@pytest.mark.parametrize("use_ddp", [True, False])
def test_unfused_plain_matches_pallas_interpret(k3_inputs, use_ddp):
    ref = riccati_backward_pallas(*k3_inputs, params=jcfg.QuadParams(), **KW, boxqp_iters=6,
                                  use_ddp=use_ddp, interpret=True)
    out = riccati_unfused.riccati_unfused_plain(*as_tensors(k3_inputs), tcfg.QuadParams(), **KW,
                                                boxqp_iters=6, use_ddp=use_ddp)
    _assert_sweep_close([o.numpy() for o in out], ref)


def test_derivatives_plain_match_jax_closed_forms():
    """K3's inputs made from K2's raw inputs equal the JAX package's closed
    forms (explicit_jacobians, the cost quadratics) on the same data."""
    H, B = 6, 32
    derivs, raw, reg = _problem_data(np.random.default_rng(1), H=H, B=B, dtype=jnp.float64,
                                     raw=True)
    derivs = [np.asarray(d) for d in derivs]
    tw, goal, tp, Hatt, att0 = (np.asarray(a) for a in raw)
    ZU, phi_z, phi_zz = derivs[8], derivs[9], derivs[10]
    k2_inputs = [ZU, tw[:, None], goal, tp, Hatt, att0, phi_z, phi_zz, np.asarray(reg)]
    out = riccati_unfused.derivatives_plain(*as_tensors(k2_inputs), tcfg.QuadParams(),
                                            tcfg.CostWeights(), tcfg.SolverConfig(horizon=H))
    for name, a, b in zip(["A", "B", "lz", "lu", "lzz", "luz", "luu", "U", "ZU"], out, derivs):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12, err_msg=name)


def test_fused_plain_is_derivatives_then_sweep():
    """K2's plain version is the composition of the two halves, output for
    output, and equals the JAX reference sweep on those derivatives."""
    H, B = 6, 128
    raw = as_tensors(backward_inputs(H, B))
    P, W, C = tcfg.QuadParams(), tcfg.CostWeights(), tcfg.SolverConfig(horizon=H)
    n2, n3 = riccati_fused.plain_calls, riccati_unfused.plain_calls
    fused = riccati_fused.riccati_backward_plain(*raw, P, W, C)
    assert (riccati_fused.plain_calls, riccati_unfused.plain_calls) == (n2 + 1, n3 + 1)
    derivs = riccati_unfused.derivatives_plain(*raw, P, W, C)
    unfused = riccati_unfused.riccati_unfused_plain(*derivs, P, **KW)
    for a, b in zip(fused, unfused):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    ref = riccati_backward_reference(*[jnp.asarray(d.numpy()) for d in derivs],
                                     params=jcfg.QuadParams(), **KW)
    _assert_sweep_close([f.numpy() for f in fused], ref)


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs(k3_inputs):
    args = as_tensors([a[..., :9] for a in map(np.asarray, k3_inputs)])
    P = tcfg.QuadParams()
    n, l = riccati_unfused.plain_calls, riccati_unfused.launches
    out = riccati_unfused.riccati_backward_unfused(*args, P, **KW)
    ref = riccati_unfused.riccati_unfused_plain(*args, P, **KW)
    assert (riccati_unfused.plain_calls, riccati_unfused.launches) == (n + 2, l)
    assert out[0].shape == (6, 4, 9) and out[1].shape == (6, 4, 17, 9) and out[4].dtype == torch.bool
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    bad_shape = list(args)
    bad_shape[4] = args[4][..., :8]
    bad_dtype = list(args)
    bad_dtype[0] = args[0].float()
    strided = list(args)
    strided[9] = torch.zeros(9, 17, dtype=torch.float64).T
    for bad in (bad_shape, bad_dtype, strided):
        with pytest.raises(ValueError):
            riccati_unfused.riccati_backward_unfused(*bad, P, **KW)


def close_(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_explicit_derivatives_equal_dynamics_taylor():
    """The closed forms the VJP uses in place of the JAX package's Taylor
    contractions, including the H2 term at a costate lam_next."""
    rng = np.random.default_rng(11)
    H = 9
    ZU = rng.normal(size=(H, 21))
    q = rng.normal(size=(H, 4))
    ZU[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    ZU[:, 17:] = rng.uniform(0, 2.44, (H, 4))
    lam = rng.normal(size=(H, 17)) * 3.0
    taylor = DynamicsTaylor(jcfg.QuadParams(), 0.1)
    A_j, B_j = taylor.jacobians(jnp.asarray(ZU))
    A, B = tana.explicit_jacobians(torch.tensor(ZU), tcfg.QuadParams(), 0.1)
    close_(A, A_j)
    close_(B, B_j)
    close_(tana.explicit_h2(torch.tensor(ZU), torch.tensor(lam), tcfg.QuadParams(), 0.1),
          taylor.hamiltonian_hessians(jnp.asarray(ZU), jnp.asarray(lam)))
