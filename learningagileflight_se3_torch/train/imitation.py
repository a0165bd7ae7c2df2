"""Stage 3: imitation learning of DNN2 from DNN1's MPC rollouts.

Port of `learningagileflight_se3_tpu/train/imitation.py`.  Per scenario the
teacher DNN1's output parameterises one MPC solve; every state along the
solved trajectory (steps 0..H-1) becomes a DNN2 input, labelled with the
teacher's traversal pose and a traversal time counted down by the solver's
dt per step.  The B teacher solves are one call of the batched solver (the
kernels on the card), and the relabelling is tensor code over (B, H).

Label modes: world frame (the reference's), `window_frame` (states and goal
in the gate's window frame, the frame deployment feeds DNN2), and
`consistent_labels` (with `window_frame`: the traversal pose mapped into the
window frame too, the frame the deployed MPC reads DNN2's output in).

Sampling: epoch e draws its scenarios from a `torch.Generator` seeded from
(seed, e) on the training device (not the JAX package's numbers).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    QuadParams,
    SamplerConfig,
    SolverConfig,
)
from learningagileflight_se3_torch.core.rotations import dcm_to_quat, quat_mul, rodrigues_to_quat
from learningagileflight_se3_torch.geometry.gate import (
    final_to_window,
    gate_centroid,
    gate_frame,
    transform_state_to_window,
)
from learningagileflight_se3_torch.models.mlp import MLP, make_dnn2
from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
from learningagileflight_se3_torch.train.rl import (
    cosine_decay_schedule,
    epoch_generator,
    init_generator,
)
from learningagileflight_se3_torch.utils.device import resolve_device


def traversal_pose_to_window(gate_pts, tra_pos, tra_ang):
    """Teacher traversal pose (world frame) -> window frame, batched over
    leading dims.  Position: the rigid transform.  Attitude: the desired
    body -> world DCM maps to body -> window, R_wg @ R_tra, re-expressed as
    the Gibbs vector q_vec / q_w (flipped to the q_w > 0 hemisphere first,
    q_w guarded at 1e-6)."""
    R_wg = gate_frame(gate_pts)
    pos_w = (R_wg @ (tra_pos - gate_centroid(gate_pts))[..., None])[..., 0]
    q_win = quat_mul(dcm_to_quat(R_wg), rodrigues_to_quat(tra_ang))
    q_win = torch.where(q_win[..., :1] < 0, -q_win, q_win)
    return pos_w, q_win[..., 1:4] / torch.clamp_min(q_win[..., :1], 1e-6)


def make_imitation_collect(model1: MLP, params_q: QuadParams, weights: CostWeights,
                           solver_cfg: SolverConfig, window_frame: bool = False,
                           consistent_labels: bool = False):
    """collect(scenarios (B,9), with_solution=False) -> (inputs (B*H, 18),
    labels (B*H, 7)) and, with `with_solution`, the teacher solve's
    MPCSolution.  The scenarios, `model1` and the solve share one device."""
    if consistent_labels and not window_frame:
        raise ValueError("consistent_labels requires window_frame=True")
    bsolve = make_batched_mpc_solver(params_q, weights, solver_cfg)
    H, dt = solver_cfg.horizon, solver_cfg.dt

    @torch.no_grad()
    def collect(scen, with_solution: bool = False):
        B = scen.shape[0]
        probs = scenario_to_problem(scen)
        gate_pts, goal = probs["gate_pts"], probs["goal_pos"]
        out = model1(scen)
        sol = bsolve(probs["x0"], torch.zeros((B, 4), dtype=scen.dtype, device=scen.device),
                     goal, out[:, 0:3], out[:, 3:6], out[:, 6])
        states = sol.state_traj[:, :H].to(scen.dtype)  # (B, H, 13)
        final = goal
        if window_frame:
            states = transform_state_to_window(gate_pts[:, None], states)
            final = final_to_window(gate_pts, goal)
        pose = out[:, 0:6]
        if consistent_labels:
            pose = torch.cat(traversal_pose_to_window(gate_pts, out[:, 0:3], out[:, 3:6]), dim=-1)
        tile = lambda a: a[:, None, :].expand(B, H, a.shape[-1])
        inputs = torch.cat([states, tile(final), tile(scen[:, 7:9])], dim=-1)
        countdown = out[:, 6:7] - torch.arange(H, dtype=scen.dtype, device=scen.device) * dt * 1.0
        labels = torch.cat([tile(pose), countdown[..., None]], dim=-1)
        data = (inputs.reshape(-1, 18), labels.reshape(-1, 7))
        return (*data, sol) if with_solution else data

    return collect


def make_imitation_train_step(model2: MLP, optimizer: torch.optim.Optimizer):
    """step(inputs, labels) -> loss (0-d tensor, before the update): one MSE
    step over a collected batch, in place."""

    def step(inputs, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((model2(inputs) - labels) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def run_imitation_training(seed: int, model1: MLP, epochs: int = 100, batch_scenarios: int = 16,
                           sgd_passes: int = 4, lr: float = 1e-6,
                           params_q: QuadParams = QuadParams(),
                           weights: CostWeights = CostWeights(),
                           solver_cfg: SolverConfig = SolverConfig(),
                           sampler_cfg: SamplerConfig = SamplerConfig(),
                           window_frame: bool = False, consistent_labels: bool = False,
                           model2: Optional[MLP] = None, lr_schedule: bool = False,
                           log_fn=print, device="cuda") -> Tuple[MLP, List[float]]:
    """Stage 3 on `device` (the card by default, which raises where
    there is none; `device="cpu"` for the CPU): per epoch one collect of
    `batch_scenarios` teacher solves and `sgd_passes` Adam steps of `model2`
    (or a DNN2 initialised from the seed) over it.  With `lr_schedule` the
    learning rate follows cosine_decay_schedule(lr, epochs * sgd_passes,
    alpha=0.01).  Scenarios are drawn in `model2`'s dtype.  Returns (model2,
    the last pass's loss of each epoch); the losses are fetched once, at the
    end."""
    device = resolve_device(device)
    model1 = model1.to(device)
    if model2 is None:
        model2 = make_dnn2(generator=init_generator(seed))
    model2 = model2.to(device)
    dtype = next(model2.parameters()).dtype
    optimizer = torch.optim.Adam(model2.parameters(), lr=lr)
    schedule = (cosine_decay_schedule(lr, epochs * sgd_passes, alpha=0.01) if lr_schedule
                else (lambda _: lr))
    collect = make_imitation_collect(model1, params_q, weights, solver_cfg, window_frame,
                                     consistent_labels)
    step = make_imitation_train_step(model2, optimizer)

    losses = []
    for e in range(epochs):
        scen = sample_scenarios(epoch_generator(seed, e, device), batch_scenarios, sampler_cfg,
                                dtype=dtype)
        inputs, labels = collect(scen)
        for p in range(sgd_passes):
            for group in optimizer.param_groups:
                group["lr"] = schedule(e * sgd_passes + p)
            loss = step(inputs, labels)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    if losses:
        log_fn(f"imitation {epochs} epochs loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    return model2, losses
