"""The port's flagship forward step (`learningagileflight_se3_torch/entry.py`)
against the JAX package's (`__graft_entry__.py` `entry()`), on the CPU in
float64.

The JAX `entry()` runs its single-problem solver under `vmap` (each lane a
`lax.while_loop` of its own); the port's `forward_step` makes one batched
solve.  The two take the same decisions on the same iterates, but a lane
that stalls (its cost stuck at a point where the model predicts a decrease
below one ulp of the cost) meets line-search tests whose two sides are
equal to rounding: `Jn < J` with every trial cost within a few ulps of J.
Such a test falls one way on one side and the other way on the other, the
regularisation schedules part, and the lane ends elsewhere at the
iteration cap.  A lane is therefore held to the JAX one (equal exit and
iterations, controls within 1e-6) or shown to part at such a tie: the
port's record names the iteration, and up to it the two solves agree
(controls within 1e-9, equal regularisation, exit and iterations).  At
H=15 and 30 iterations this is lane 6 of the PRNGKey(0) DNN1 (its first
tie at DDP iteration 18) and lanes 5 and 7 of `nn_deep` (both at 22; lane
7's paths part at 24); the rest agree.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.models.sampler import scenario_to_problem as j_scenario_to_problem
from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver as j_make_mpc_solver
from learningagileflight_se3_tpu.utils.checkpoint import load_params

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.entry import make_forward_step
from learningagileflight_se3_torch.models.sampler import scenario_to_problem as tscenario_to_problem
from learningagileflight_se3_torch.solver import ilqr as tilqr
from learningagileflight_se3_torch.solver.watch import decision_record, first_tie, kept_solutions
from learningagileflight_se3_torch.utils import weights as tweights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402

F64 = torch.float64
H, CAP = 15, 30
# a lane agrees: the same exit and iterations, controls within CONTROLS;
# up to a tie: controls within UP_TO_TIE, the same regularisation, exit
# and iterations
CONTROLS, UP_TO_TIE = 1e-6, 1e-9
MIN_AGREE = 5  # of the 8 example lanes (7 and 6 agree at H=15, 30 iterations)


def example_args():
    """`__graft_entry__.entry()[1]`, as entry() makes it on an accelerator:
    JAX's default 32-bit types."""
    with jax.enable_x64(False):
        return graft.entry()[1]


def dnn1_pair(name):
    """(flax params, the port's DNN1) for "key0" (entry()'s PRNGKey(0) init,
    the port's from weights/entry_args.npz) or "nn_deep" (the shipped
    checkpoint and its export)."""
    if name == "key0":
        return example_args()[0], tweights.entry_args()[0]
    like = jmlp.make_dnn1().init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    return (load_params(os.path.join(REPO, "artifacts", "nn_deep"), like=like),
            tweights.load_dnn1(tweights.NN_DEEP_DNN1))


def jax_solution(nn_params, scenarios, horizon, max_iters, tol=1e-6, gtol=1e-5):
    """The JAX entry()'s forward step (__graft_entry__.py:48-67), built the
    same way at these settings, jitted, returning each lane's whole solution
    in place of its first control."""
    params_q, weights, solver_cfg, _, _ = graft._configs(horizon, max_iters, tol, gtol)
    model = jmlp.make_dnn1()
    solve = j_make_mpc_solver(params_q, weights, solver_cfg, return_gains=False)

    def forward_step(nn_params, scenarios):
        def one(scen):
            prob = j_scenario_to_problem(scen)
            out = model.apply(nn_params, scen)
            return solve(prob["x0"], jnp.zeros(4, scen.dtype), prob["goal_pos"], out[0:3], out[3:6], out[6])

        return jax.vmap(one)(scenarios)

    return jax.jit(forward_step)(nn_params, jnp.asarray(scenarios))


def port_solution(dnn1, scenarios, horizon, max_iters, tol=1e-6, gtol=1e-5):
    """make_forward_step's first controls on the CPU in float64, the batched
    solve's whole solution and its decision record (solver/watch.py)."""
    with kept_solutions() as sols, decision_record() as rec:
        step = make_forward_step(horizon, max_iters, tol, gtol, device="cpu", dtype=F64)
        u0 = step(dnn1, np.asarray(scenarios, np.float64))
    assert len(sols) == 1 and u0.shape == (len(scenarios), 4) and u0.dtype == F64
    assert torch.equal(u0, sols[0].control_traj[:, 0])
    return u0, sols[0], rec


def hold_lanes(params, dnn1, scen, horizon, got, ref, rec, same, tol, gtol):
    """Each lane that does not meet `same(lane)` must part at a tie, and
    agree with the JAX solve up to it.  Returns the lanes shown tied."""
    tied = {}
    for lane in range(len(scen)):
        if same(lane):
            continue
        tie = first_tie(rec, lane, int(got.iterations[lane]))
        assert tie is not None, (
            f"lane {lane} parts from the JAX solve (exit {int(got.status[lane])} / {int(ref.status[lane])}, "
            f"iterations {int(got.iterations[lane])} / {int(ref.iterations[lane])}) with no tie on its path")
        tied[lane] = tie
    for k in sorted({k for k, _ in tied.values()}):
        lanes = [lane for lane, (kl, _) in tied.items() if kl == k]
        ref_k = jax_solution(params, scen, horizon, k, tol, gtol)
        _, got_k, _ = port_solution(dnn1, scen, horizon, k, tol, gtol)
        for lane in lanes:
            what = f"lane {lane} before its tie ({tied[lane][1]})"
            np.testing.assert_allclose(got_k.control_traj[lane].numpy(), np.asarray(ref_k.control_traj[lane]),
                                       rtol=0, atol=UP_TO_TIE, err_msg=what)
            assert float(got_k.reg_final[lane]) == float(ref_k.reg_final[lane]), what
            assert int(got_k.status[lane]) == int(ref_k.status[lane]), what
            assert int(got_k.iterations[lane]) == int(ref_k.iterations[lane]) == k, what
    for lane, (_, text) in tied.items():
        print(f"lane {lane} parts at a tie: {text}")
    return tied


def test_example_args_equal_jax_entry():
    """weights/entry_args.npz is `__graft_entry__.entry()[1]`: every array
    as scripts/export_entry_args.py exports it now, the scenarios and the
    DNN1's parameters bit for bit, and the port's DNN1 gives the flax
    model's outputs on them (1e-5 in float32, 1e-12 in float64)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from export_entry_args import entry_args as export
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    want = export()
    with np.load(tweights.ENTRY_ARGS) as z:
        assert sorted(z.files) == sorted([*want, "source"])
        for k in want:
            assert z[k].dtype == want[k].dtype == np.float32, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    params, scen = example_args()
    dnn1, scen_t = tweights.entry_args()
    assert scen_t.dtype == np.float32 and scen_t.shape == (8, 9)
    np.testing.assert_array_equal(scen_t, np.asarray(scen))
    want = tweights.jax_params_to_torch(jax.device_get(params))
    got = dnn1.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    model = jmlp.make_dnn1()
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        x = np.asarray(scen).astype(dtype)
        out = dnn1(torch.from_numpy(x)).detach().numpy()
        assert out.dtype == dtype
        np.testing.assert_allclose(out, np.asarray(model.apply(params, jnp.asarray(x))), rtol=tol, atol=tol)


def check_capped(name, horizon):
    """The forward step at `horizon` and the entry's 30 iterations, tol 1e-6,
    gtol 1e-5, on the 8 example scenarios, against the JAX entry()'s: each
    lane's exit, iterations and whole control trajectory (first controls
    included) equal, controls within 1e-6, or the lane parts at a tie and
    agrees up to it; at least MIN_AGREE lanes agree."""
    params, dnn1 = dnn1_pair(name)
    scen = np.asarray(example_args()[1], np.float64)
    ref = jax_solution(params, scen, horizon, CAP)
    u0, got, rec = port_solution(dnn1, scen, horizon, CAP)
    dU = np.abs(got.control_traj.numpy() - np.asarray(ref.control_traj)).max(axis=(1, 2))

    def same(lane):
        return (int(got.status[lane]) == int(ref.status[lane])
                and int(got.iterations[lane]) == int(ref.iterations[lane]) and dU[lane] <= CONTROLS)

    tied = hold_lanes(params, dnn1, scen, horizon, got, ref, rec, same, 1e-6, 1e-5)
    agree = [lane for lane in range(8) if lane not in tied]
    assert len(agree) >= MIN_AGREE, f"only lanes {agree} agree"
    np.testing.assert_allclose(u0.numpy()[agree], np.asarray(ref.control_traj[:, 0])[agree], rtol=0, atol=CONTROLS)
    return tied


@pytest.mark.parametrize("name", ["key0", "nn_deep"])
def test_forward_step_matches_jax_entry(name):
    """check_capped at H=15: the PRNGKey(0) DNN1 of entry() (near-zero and
    negative traversal times, which go to the solver unfiltered in both) and
    the shipped nn_deep (realistic ones)."""
    check_capped(name, H)


def test_forward_step_converged_matches_jax_entry():
    """The shipped nn_deep at H=15 with 300 iterations and the solver's
    default tolerances (tol 1e-9, gtol 1e-7), as
    test_single_solve_matches_jax_h15: every lane converges on both sides;
    where both end stationary the controls agree within 1e-6 and the costs
    within 1e-9 relative; a lane that ends otherwise parts at a tie (lane 7:
    the port's stalls, the JAX one's ends stationary) and agrees up to it."""
    params, dnn1 = dnn1_pair("nn_deep")
    scen = np.asarray(example_args()[1], np.float64)
    ref = jax_solution(params, scen, H, 300, 1e-9, 1e-7)
    _, got, rec = port_solution(dnn1, scen, H, 300, 1e-9, 1e-7)
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    cost_ref = np.asarray(ref.cost)

    def same(lane):
        return int(got.status[lane]) == int(ref.status[lane]) == 1

    tied = hold_lanes(params, dnn1, scen, H, got, ref, rec, same, 1e-9, 1e-7)
    agree = [lane for lane in range(8) if lane not in tied]
    assert len(agree) >= MIN_AGREE, f"only lanes {agree} agree"
    np.testing.assert_allclose(got.control_traj.numpy()[agree], np.asarray(ref.control_traj)[agree],
                               rtol=0, atol=CONTROLS)
    np.testing.assert_allclose(got.cost.numpy()[agree], cost_ref[agree], rtol=1e-9, atol=0)


def test_forward_step_lanes_are_independent():
    """The shipped nn_deep on the 8 example scenarios (H=15, 30 iterations,
    float64): forward_step on each scenario alone equals its lane of the
    batch within 1e-12, or the lane meets a tie (solver/watch.py
    `first_tie`; lane 5).
    There the batched solve is still lane-independent bit for bit (the lane
    solved alone on the batch's DNN1 outputs equals its lane of the batch),
    but DNN1 is not: its matrix products round by batch size (within 1e-14),
    and the tie turns that rounding into another path."""
    dnn1 = tweights.load_dnn1(tweights.NN_DEEP_DNN1)
    scen = torch.as_tensor(tweights.entry_args()[1], dtype=F64)
    batch, sol, rec = port_solution(dnn1, scen, H, CAP)
    step = make_forward_step(H, CAP, device="cpu", dtype=F64)
    with torch.no_grad():
        out = dnn1(scen)
    prob = tscenario_to_problem(scen)
    solve = tilqr.make_batched_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(),
                                          tcfg.SolverConfig(horizon=H, max_iters=CAP, tol=1e-6, gtol=1e-5))
    tied = []
    for i in range(len(scen)):
        if (step(dnn1, scen[i:i + 1])[0] - batch[i]).abs().max() <= 1e-12:
            continue
        tie = first_tie(rec, i, int(sol.iterations[i]))
        assert tie is not None, f"lane {i} alone differs from its lane of the batch with no tie on its path"
        with torch.no_grad():
            assert (dnn1(scen[i:i + 1])[0] - out[i]).abs().max() <= 1e-14, f"lane {i}: DNN1 alone"
        one = solve(prob["x0"][i:i + 1], torch.zeros((1, 4), dtype=F64), prob["goal_pos"][i:i + 1],
                    out[i:i + 1, 0:3], out[i:i + 1, 3:6], out[i:i + 1, 6])
        assert torch.equal(one.control_traj[0], sol.control_traj[i]), f"lane {i}: the solve depends on its batch"
        print(f"lane {i} alone parts from the batch at a tie: {tie[1]}")
        tied.append(i)
    assert len(tied) <= len(scen) - MIN_AGREE, f"lanes {tied} part"


@pytest.mark.slow
def test_forward_step_matches_jax_entry_h50():
    """check_capped at the entry's own horizon, H=50, with the shipped nn_deep."""
    check_capped("nn_deep", 50)
