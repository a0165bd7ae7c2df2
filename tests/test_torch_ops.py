"""PyTorch port, the two kernels' modules.

On the CPU: the plain versions of K1 (rollout) and K2 (fused backward sweep)
against the JAX Pallas kernels in interpret mode, in float64 on the same
numpy inputs; the wrappers' dispatch and input checks; the launch-constant
struct against its C mirror.  The kernels themselves are held against the
plain versions on the card by tests/test_torch_gpu.py."""

import ctypes
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.ops.riccati_fused import riccati_backward_fused
from learningagileflight_se3_tpu.ops.rollout_pallas import rollout_forward_pallas

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.ops import build, riccati_fused, rollout
from learningagileflight_se3_torch.ops.inputs import as_tensors, backward_inputs, rollout_inputs


VARIANTS = {
    "main": (dict(), dict()),
    "pybullet": (dict(squared_attitude=False), dict(u_ub=2.4)),
    "wqf_wbound": (dict(wqf=2.0), dict(w_bound_weight=3.0, w_bound=0.3)),
}


def _cfgs(variant, H):
    wkw, skw = VARIANTS[variant]
    return (jcfg.QuadParams(), jcfg.CostWeights(**wkw), jcfg.SolverConfig(horizon=H, **skw),
            tcfg.QuadParams(), tcfg.CostWeights(**wkw), tcfg.SolverConfig(horizon=H, **skw))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rollout_plain_matches_pallas_interpret(variant):
    H = 7
    args = rollout_inputs(H, 128)
    jP, jW, jC, P, W, C = _cfgs(variant, H)
    ref = rollout_forward_pallas(*[jnp.asarray(a) for a in args], jP, jW, jC, interpret=True)
    out = rollout.rollout_forward_plain(*as_tensors(args), P, W, C)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("variant,use_ddp", [("main", True), ("pybullet", True),
                                             ("wqf_wbound", True), ("main", False)])
def test_riccati_plain_matches_fused_interpret(variant, use_ddp):
    H = 6
    args = backward_inputs(H, 128)
    jP, jW, jC, P, W, C = _cfgs(variant, H)
    ref = riccati_backward_fused(*[jnp.asarray(a) for a in args], jP, jW, jC,
                                 boxqp_iters=6, use_ddp=use_ddp, interpret=True)
    out = riccati_fused.riccati_backward_plain(*as_tensors(args), P, W, C,
                                               boxqp_iters=6, use_ddp=use_ddp)
    for name, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        if name == "fail":
            np.testing.assert_array_equal(a, b)
            continue
        assert (np.isnan(a) == np.isnan(b)).all(), f"{name}: NaN pattern"
        both = np.isfinite(a) & np.isfinite(b)
        rel = np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2))
        assert rel < 1e-8, f"{name}: rel err {rel}"


def test_wrappers_take_plain_versions_on_cpu():
    H = 5
    _, _, _, P, W, C = _cfgs("main", H)
    r_args = as_tensors(rollout_inputs(H, 9))
    b_args = as_tensors(backward_inputs(H, 9))
    n_r, n_b = rollout.plain_calls, riccati_fused.plain_calls
    l_r, l_b = rollout.launches, riccati_fused.launches
    out = rollout.rollout_forward(*r_args, P, W, C)
    ref = rollout.rollout_forward_plain(*r_args, P, W, C)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    kk, KK, dV1, dV2, fail, pg = riccati_fused.riccati_backward(*b_args, P, W, C)
    assert kk.shape == (H, 4, 9) and KK.shape == (H, 4, 17, 9) and fail.dtype == torch.bool
    assert (rollout.plain_calls, riccati_fused.plain_calls) == (n_r + 2, n_b + 1)
    assert (rollout.launches, riccati_fused.launches) == (l_r, l_b)


def test_wrappers_check_inputs():
    H = 4
    _, _, _, P, W, C = _cfgs("main", H)
    args = as_tensors(rollout_inputs(H, 8))
    bad_shape = list(args)
    bad_shape[3] = args[3][:, :, :16]
    bad_dtype = list(args)
    bad_dtype[0] = args[0].float()
    strided = list(args)
    strided[6] = torch.zeros(8, 3, dtype=torch.float64).T
    bad_kind = [a.to(torch.int64) for a in args]
    for bad, err in [(bad_shape, ValueError), (bad_dtype, ValueError),
                     (strided, ValueError), (bad_kind, TypeError)]:
        with pytest.raises(err):
            rollout.rollout_forward(*bad, P, W, C)


def test_kernel_consts_mirror_the_c_struct():
    """ops/build.py KernelConsts and laf::Consts in csrc/lane_algebra.cuh
    list the same fields in the same order, so ctypes lays them out alike."""
    with open(os.path.join(build.CSRC_DIR, "lane_algebra.cuh")) as f:
        body = re.search(r"struct Consts \{(.*?)\};", f.read(), re.S).group(1)
    c_fields = []
    for ctype, names in re.findall(r"(double|int) ([^;]+);", body):
        c_fields += [(n.strip(), ctype) for n in names.split(",")]
    py_fields = [(n, "double" if t is ctypes.c_double else "int")
                 for n, t in build.KernelConsts._fields_]
    assert py_fields == c_fields
    assert ctypes.sizeof(build.KernelConsts) == 20 * 8 + 4 * 4
