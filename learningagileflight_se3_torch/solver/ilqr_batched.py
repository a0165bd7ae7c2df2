"""Natively batched control-limited DDP over the port's kernels.

Port of `learningagileflight_se3_tpu/solver/ilqr_batched.py`
(`make_batched_mpc_solver_pallas`).  Each DDP iteration runs

  1. K2, the fused backward sweep (`ops/riccati_fused.py`): Jacobian blocks,
     cost quadratics, the projected-gradient adjoint, boxQP and gains, on
     the trajectory and terminal quadratics that K6's `prepare` lays out;
  2. K6's `decide`: the active and deep lanes, the (trip, lane) grid of
     step lengths and whether any lane is live;
  3. the lock-step per-lane backtracking line search, every trip at once:
     one launch of K1, the closed-loop rollout with cost (`ops/rollout.py`),
     over that grid, then the first-accept rule over the trips
     (`ops/line_search.py first_accept`: K5 on the card, its plain version
     on the CPU), the same on every device and drive;
  4. K6's `commit`: the new state, from the selects of the accepted step to
     the exit status, every field gated by `go`.

K6 (`ops/ddp_glue.py`) is one CUDA kernel a step on the card and its plain
PyTorch version on the CPU, which make the same decisions bit for bit.

K1 with zero gains also makes the initial open-loop rollout.  The semantics
are the JAX solver's: the Tassa regularization schedule, adaptive and
capped line search with deep-ladder escalation, the progress window, the
`sane` guards, the runtime `max_iters`, `quantize_t` and the exit status.
The TPU's rule that the batch be a multiple of 128 is gone: the kernels
mask their own ragged edge.

`cfg.backward` selects the sweep, as the JAX single-problem solver's does
(`solver/ilqr.py`): "sequential" is K2, "parallel" the closed-form
derivatives followed by the parallel-in-time sweep of
`solver/parallel_riccati.py` (plain PyTorch; iLQR only, so `use_ddp=True`
raises).  The JAX package's batched Pallas solver ignores `cfg.backward`
and always runs its fused kernel; its `backend="xla"` batched solver, the
vmapped single-problem solver, honours it.  The port follows the `xla`
backend here.  The line search is the same either way.

Trajectories stay in the kernels' time-major, batch-last layout
(Z (H+1,17,B), U (H,4,B), KK (H,4,17,B)) for the whole solve, so no
transposing copy precedes a launch; per-lane selections broadcast over the
trailing batch axis.

The solve is the JAX package's shape: a setup (`BatchedSolver.setup`, once
per solve), then a device-side loop of DDP iterations (`iteration`, a pure
step on a `SolveState`) whose line search rolls out a fixed number of trips.
Every trip is gated on the device by whether any lane is still live in the
search, and every iteration by whether any lane is still live in the solve
(`go`, which `decide` finds), so a trip or an iteration run past the loop's
exit changes nothing:
the solver is not idempotent past its exit (a trip would still accept a
lane at a deeper step, an iteration would rewrite `pg` and `ls_evals`).
It runs in one of three ways:

  * graph (a standalone solve on CUDA tensors): `GRAPH_BLOCK` iterations
    are captured once per batch size, dtype and device into one CUDA graph
    (a private memory pool shared by the solver's captures) and the graph
    is replayed until the done flag, copied to pinned host memory after
    each block, says that no lane is live or the cap is reached.  Block
    n+1 is queued before block n's flag is read, so at most one block runs
    past the exit, as gated no-ops, and a solve makes at most
    ceil(max_iters / GRAPH_BLOCK) - 1 host reads.  A capture that fails
    raises: nothing falls back to eager.
  * chain (a solve traced inside an enclosing capture: the tick's, a flight
    step's): `run_chain`, the setup and ceil(cap / GRAPH_BLOCK) blocks of
    the same gated iterations, each block under a CUDA-graph conditional
    IF node whose predicate is `live_any` of the carry before it
    (utils/graphs.py `while_blocks`), so a block past the exit is skipped
    on the device and the solve makes no host read.
  * eager: the loop on the host, which stops at a host test (`.any()`) per
    iteration.  It is the CPU's loop (the gated iterations it skips are
    no-ops).  On the card it runs in two cases
    only (`BatchedSolver.graphed`): while `solver/watch.py`'s watchers are
    on, since they see the kernel wrappers' Python calls, which a graph
    replay does not make; and for cfg.backward="parallel", whose batched
    `torch.linalg.solve_ex` cannot be captured (on an H100 with torch 2.11
    its LU raises cudaErrorStreamCaptureUnsupported inside a capture).

`run_blocks` is the graph loop's schedule without the capture, and
`run_chain(..., drive="blocks")` the chain's, so the CPU tests hold the
captured code bit for bit against the eager loop.

With utils/profiling.py's spans on, a solve records the device spans
"solve.setup", "solve.block" (each block of GRAPH_BLOCK iterations, in the
captured block and in each conditional body of a chain), "solve.copy_in",
"solve.copy_out" (the graph's static buffers) and "solve.solution", and
host spans of the same names with "solve.launch" (a block's replay) and
"solve.read" (the wait for a block's flag); on the card each line search
that runs a trip adds [1, its trips] to the counter "ls.grid", and each
iteration with `go` true [1, its active lanes] to "ddp.glue".  Graphs
captured with spans on and off are kept apart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.ops import ddp_glue
from learningagileflight_se3_torch.ops import line_search as ls_grid
from learningagileflight_se3_torch.ops.riccati_fused import riccati_backward
from learningagileflight_se3_torch.ops.rollout import rollout_forward, rollout_trials
from learningagileflight_se3_torch.solver.analytic import attitude_curvature, attitude_offset
from learningagileflight_se3_torch.solver.ilqr import MPCSolution
from learningagileflight_se3_torch.solver.parallel_riccati import derivatives, parallel_backward
from learningagileflight_se3_torch.utils import graphs
from learningagileflight_se3_torch.utils.profiling import spans

NX = 13
NU = 4
NZ = NX + NU

# DDP iterations per captured graph.  A solve replays it ceil(iterations
# run / GRAPH_BLOCK) + 1 times at most: the flag read after each block
# waits for the card, and the block queued behind the last live one and the
# rest of the last live one are gated no-ops.  4 keeps the no-ops of a solve
# that stops early (the tick: 13 of 30 iterations) under 7 iterations and
# its host reads at 60 / 4 = 15 at the bench point.
GRAPH_BLOCK = 4

class SolveState(NamedTuple):
    """The DDP loop's carry, in the kernels' layout; per-lane fields are (B,).
    `max_iters` is the runtime cap as a 0-dim tensor, so one captured graph
    serves every cap."""

    Z: torch.Tensor          # (H+1,17,B)
    U: torch.Tensor          # (H,4,B)
    J: torch.Tensor          # cost
    KK: torch.Tensor         # (H,4,17,B) gains of the last accepted sweep
    reg: torch.Tensor        # Tassa regularization
    done: torch.Tensor       # bool
    it: torch.Tensor         # int32 iterations run
    pg: torch.Tensor         # projected gradient of the last sweep
    ls_n: torch.Tensor       # () int32 lock-step line-search trips
    ls0: torch.Tensor        # int32 warm line-search index
    n_np: torch.Tensor       # int32 iterations since the last improvement
    J_chk: torch.Tensor      # cost at the progress window's start
    w_it: torch.Tensor       # int32 iterations into the progress window
    st: torch.Tensor         # int32 exit status
    max_iters: torch.Tensor  # () int32


class Problem(NamedTuple):
    """The per-solve constants of the loop, in the kernels' layout."""

    t_w: torch.Tensor       # (H,1,B)
    goal: torch.Tensor      # (3,B)
    tra_pos: torch.Tensor   # (3,B)
    tra_quat: torch.Tensor  # (4,B)
    Hatt: torch.Tensor      # (4,4,B)
    att0: torch.Tensor      # (1,B)


def live_any(s: SolveState) -> torch.Tensor:
    """0-dim bool on the device: is any lane still iterating?"""
    return ((~s.done) & (s.it < s.max_iters)).any()


def _schedule(n_blocks: int, queue, read) -> None:
    """Queue block 0; then, for each block n, queue block n+1 before reading
    block n's flag, and stop at a flag that says no lane is live.  The last
    block's flag is never read: no block follows it."""
    if n_blocks == 0:
        return
    queue(0)
    for n in range(n_blocks - 1):
        queue(n + 1)
        if not read(n):
            return


class _Graph(NamedTuple):
    graph: graphs.Graph    # one block
    state: SolveState      # static buffers: the carry in and out of a block
    problem: Problem       # static buffers: the solve's constants
    flag: torch.Tensor     # () bool, live_any after the block
    pinned: torch.Tensor   # (2,) bool in pinned host memory
    events: tuple


class BatchedSolver:
    """solve(x0[B,13], u_last[B,4], goal[B,3], tra_pos[B,3], tra_ang[B,3],
    t[B], U_init=None|[B,H,4], max_iters=None) -> MPCSolution (leading B).

    Any batch size; the solve runs on x0's device, in x0's float dtype
    promoted to at least float32.  On a CUDA device the DDP loop runs as a
    replayed CUDA graph (see the module's docstring; `graphed` says when),
    captured at the first solve of each batch size and dtype, or, inside an
    enclosing capture, as a chain of conditional blocks."""

    def __init__(self, params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                 return_gains: bool = False):
        if cfg.backward == "parallel":
            if cfg.use_ddp:
                raise ValueError(
                    "cfg.backward='parallel' is a Gauss-Newton (iLQR) sweep and "
                    "cannot honor use_ddp=True: the associative-scan composition "
                    "has no slot for the second-order dynamics terms. Set "
                    "use_ddp=False explicitly to opt into the iLQR downgrade."
                )
        elif cfg.backward != "sequential":
            raise ValueError(f"unknown cfg.backward: {cfg.backward!r}")
        self.params, self.weights, self.cfg = params, weights, cfg
        self.return_gains = return_gains
        n_alpha, stride = cfg.line_search_steps, cfg.ls_max_trips
        self.n_deep = -(-n_alpha // stride)
        # the most trips any lane can take in one line search
        self.n_trips = min(n_alpha, max(cfg.ls_max_trips, self.n_deep))
        self._graphs = {}
        self.graph_captures = graphs.Captures()

    # ------------------------------------------------------------ kernels
    def rollout(self, Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat):
        return rollout_forward(Z_ref, U_ref, kk, KK, t_w, alpha, goal, tra_pos, tra_quat,
                               self.params, self.weights, self.cfg)

    def rollout_cost(self, z0, U, t_w, goal, tra_pos, tra_quat):
        """Open-loop rollout with cost: K1 with zero gains.
        z0 (17,B), U (H,4,B) -> Z (H+1,17,B), J (B,)."""
        H = self.cfg.horizon
        B = z0.shape[-1]
        Z_ref = z0.expand(H, NZ, B).contiguous()
        kk0 = torch.zeros((H, NU, B), dtype=z0.dtype, device=z0.device)
        KK0 = torch.zeros((H, NU, NZ, B), dtype=z0.dtype, device=z0.device)
        alpha0 = torch.zeros((1, B), dtype=z0.dtype, device=z0.device)
        Zs, _, c = self.rollout(Z_ref, U, kk0, KK0, t_w, alpha0, goal, tra_pos, tra_quat)
        return torch.cat([z0[None], Zs]), c

    def ladder(self) -> ls_grid.Ladder:
        cfg = self.cfg
        return ls_grid.Ladder(cfg.line_search_steps, cfg.ls_max_trips, self.n_deep)

    def glue_consts(self):
        """K6's constants for this solver's settings (made at each call, so
        that they follow `n_trips`)."""
        return ddp_glue.glue_consts(self.cfg, self.weights, self.ladder(), self.n_trips)

    def backward(self, Z, U, p: Problem, reg):
        """The backward sweep on the current trajectory: K2 (sequential), or
        the closed-form derivatives and the parallel-in-time sweep; the
        terminal quadratics and the sweep's ZU layout are K6's `prepare`."""
        cfg = self.cfg
        ZU, phi_z, phi_zz = ddp_glue.prepare(Z, U, p.goal, self.weights, self.glue_consts())
        if cfg.backward == "parallel":
            derivs = derivatives(ZU, p.t_w, p.goal, p.tra_pos, p.Hatt, p.att0, phi_z, phi_zz,
                                 self.params, self.weights, cfg)
            return parallel_backward(derivs, U, reg, cfg, cfg.u_lb, cfg.u_ub)
        return riccati_backward(
            ZU, p.t_w, p.goal, p.tra_pos, p.Hatt, p.att0, phi_z, phi_zz, reg[None],
            self.params, self.weights, cfg, boxqp_iters=cfg.boxqp_iters, use_ddp=cfg.use_ddp,
        )

    def line_search(self, Z, U, J, kk, KK, p: Problem, dV1, dV2, ls0, deep, skip, alpha):
        """Per-lane first-acceptable-alpha backtracking, each lane from its
        warm index `ls0`; `deep` lanes sweep the whole ladder at a coarse
        stride; `skip` (finished) lanes enter accepted and cost no trip.
        Every trip at once: `alpha` (n_trips, B) the step length each trip
        would give each lane (K6's `decide`, or `ls_grid.alpha_grid`), one
        K1 launch over the (trip, lane) grid and the ladder's recurrence
        replayed on its costs (`ls_grid.first_accept`).  A trip is gated on
        the device by whether any lane is still live in the search: past
        that it accepts nothing and counts no trip."""
        Zn, Un, Jn = rollout_trials(Z[:-1], U, kk, KK, p.t_w, alpha, p.goal, p.tra_pos, p.tra_quat,
                                    self.params, self.weights, self.cfg)
        return ls_grid.first_accept(Z, U, J, Zn, Un, Jn, alpha, dV1, dV2, ls0, deep, skip, self.ladder(),
                                    count=grid_counter(J.device))

    # ------------------------------------------------------------- the loop
    def setup(self, x0, u_last, goal_pos, tra_pos, tra_ang, t,
              U_init: Optional[torch.Tensor] = None, max_iters: Optional[int] = None):
        """Inputs to the kernels' layout, the per-problem constants, the warm
        start's guard and the first rollout: (SolveState, Problem, cap), cap
        the runtime iteration cap (default cfg.max_iters) as an int."""
        cfg, weights, H = self.cfg, self.weights, self.cfg.horizon
        lb, ub = cfg.u_lb, cfg.u_ub
        cap = cfg.max_iters if max_iters is None else int(max_iters)
        device = x0.device
        dtype = torch.promote_types(x0.dtype, torch.float32)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        B = x0.shape[0]
        x0 = as_t(x0)
        u_last, goal, tra_pos, tra_ang = as_t(u_last), as_t(goal_pos), as_t(tra_pos), as_t(tra_ang)
        t = torch.as_tensor(t, device=device)
        if cfg.quantize_t:
            t = torch.round(t * 10.0) / 10.0
        tra_quat = rodrigues_to_quat(tra_ang)
        # per-problem attitude curvature: constant across solver iterations
        Hatt = attitude_curvature(tra_quat).permute(1, 2, 0).contiguous()
        att0 = attitude_offset(tra_quat)[None].contiguous()
        ks = torch.arange(H, dtype=dtype, device=device)
        t_w = weights.tra_amp * torch.exp(
            -weights.tra_decay * (cfg.dt * ks[:, None] - t[None, :].to(dtype)) ** 2
        )[:, None, :].contiguous()  # (H,1,B)
        z0 = torch.cat([x0, u_last], dim=-1).T.contiguous()
        p = Problem(t_w, goal.T.contiguous(), tra_pos.T.contiguous(), tra_quat.T.contiguous(), Hatt, att0)

        U0 = torch.full((H, NU, B), 0.5 * (lb + ub), dtype=dtype, device=device)
        if U_init is not None:
            # warm-start guard of the JAX single-problem solver (ilqr.py):
            # a lane whose warm rollout cost is not sane restarts from the
            # midpoint init (the JAX batched solver lacks this guard)
            Uw = as_t(U_init).permute(1, 2, 0).contiguous()  # (B,H,4) -> (H,4,B)
            _, Jw = self.rollout_cost(z0, Uw, t_w, p.goal, p.tra_pos, p.tra_quat)
            U0 = torch.where(torch.isfinite(Jw) & (Jw.abs() < 1e12), Uw, U0)

        Z, J = self.rollout_cost(z0, U0, t_w, p.goal, p.tra_pos, p.tra_quat)
        i32 = dict(dtype=torch.int32, device=device)
        state = SolveState(
            Z=Z, U=U0, J=J,
            KK=torch.zeros((H, NU, NZ, B), dtype=dtype, device=device),
            reg=torch.full((B,), cfg.reg_init, dtype=dtype, device=device),
            done=torch.zeros(B, dtype=torch.bool, device=device),
            it=torch.zeros(B, **i32),
            pg=torch.full((B,), float("inf"), dtype=dtype, device=device),
            ls_n=torch.zeros((), **i32),
            ls0=torch.zeros(B, **i32),
            n_np=torch.zeros(B, **i32),
            J_chk=J,
            w_it=torch.zeros(B, **i32),
            st=torch.zeros(B, **i32),
            max_iters=torch.full((), cap, **i32),
        )
        return state, p, cap

    def iteration(self, s: SolveState, p: Problem, go: Optional[torch.Tensor] = None) -> SolveState:
        """One DDP iteration, every update gated by `go` (0-dim bool on the
        device; with go False the state comes back unchanged).  go None:
        whether any lane of s is live (`live_any(s)`), as K6's `decide`
        finds it with no launch of its own."""
        cfg, glue = self.cfg, self.glue_consts()
        kk, KK_new, dV1, dV2, fail, pg = self.backward(s.Z, s.U, p, s.reg)
        deep, skip, alpha, live = ddp_glue.decide(s, dV1, dV2, cfg, self.ladder(), self.n_trips, glue)
        accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips = self.line_search(
            s.Z, s.U, s.J, kk, KK_new, p, dV1, dV2, s.ls0, deep, skip, alpha,
        )
        return ddp_glue.commit(s, KK_new, dV1, dV2, fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips,
                               live if go is None else go, cfg, glue, count=glue_counter(s.J.device))

    def run_block(self, s: SolveState, p: Problem, k: int) -> SolveState:
        """k gated iterations with no host read: what a graph captures."""
        with spans.device("solve.block", s.J.device):
            for _ in range(k):
                s = self.iteration(s, p)
        return s

    def run_eager(self, s: SolveState, p: Problem, cap: int) -> SolveState:
        """The host loop: a host test per iteration (the cap is read on the
        device, from `s.max_iters`; `cap` is the loops' common signature)."""
        while True:
            go = live_any(s)
            if not graphs.read(go):
                return s
            s = self.iteration(s, p, go)

    def run_chain(self, s: SolveState, p: Problem, cap: int, drive: str = "chain") -> SolveState:
        """The loop as ceil(cap / GRAPH_BLOCK) blocks of gated iterations,
        each under a conditional IF node of the capture that is open ("chain",
        the carry `s` written in place), or each run ("blocks", the CPU's
        check of what the chain captures); no host read either way."""
        return graphs.while_blocks(s, live_any, lambda st: self.iteration(st, p), GRAPH_BLOCK,
                                   -(-cap // GRAPH_BLOCK), drive, span="solve.block")

    def run_blocks(self, s: SolveState, p: Problem, cap: int, k: Optional[int] = None) -> SolveState:
        """The graph loop's schedule with the blocks run in place of the
        replays (no capture): the CPU's check of the captured code."""
        k = GRAPH_BLOCK if k is None else k
        box, flags = [s], []

        def queue(n):
            box[0] = self.run_block(box[0], p, k)
            flags.append(live_any(box[0]))

        _schedule(-(-cap // k), queue, lambda n: graphs.read(flags[n]))
        return box[0]

    def graphed(self, device) -> bool:
        """Whether a solve on `device` runs as replays of a CUDA graph (or,
        inside an enclosing capture, as a chain of its blocks): on a CUDA
        device, with the sequential sweep (K2), outside the watchers."""
        return (torch.device(device).type == "cuda" and self.cfg.backward == "sequential"
                and not graphs.eager_on_card)

    def prepare(self, B: int, dtype, device) -> None:
        """Capture the graph for batch size B in `dtype` on `device` now,
        not at the first solve (a no-op where the solve is not `graphed` or
        once captured): a deployment makes its solver before the first
        tick.  The warm-up block runs on a hover problem."""
        if not self.graphed(device):
            return
        kw = dict(dtype=dtype, device=device)
        x0 = torch.zeros((B, NX), **kw)
        x0[:, 6] = 1.0
        zeros3 = torch.zeros((B, 3), **kw)
        s, p, _ = self.setup(x0, torch.zeros((B, NU), **kw), zeros3, zeros3, zeros3, torch.zeros(B, **kw))
        if self._key(s) not in self._graphs:
            with torch.no_grad():
                self._graphs[self._key(s)] = self._capture(s, p)

    @staticmethod
    def _key(s: SolveState):
        return s.J.shape[0], s.J.dtype, s.J.device, spans.on

    def run_graph(self, s: SolveState, p: Problem, cap: int) -> SolveState:
        """The loop as replays of a captured block of GRAPH_BLOCK
        iterations; returns the final state cloned out of the graph's
        static buffers (the next solve overwrites them)."""
        key = self._key(s)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(s, p)
        device = s.J.device
        with spans.host("solve.copy_in"), spans.device("solve.copy_in", device):
            for dst, src in zip((*g.state, *g.problem), (*s, *p)):
                dst.copy_(src)

        def queue(n):
            with spans.host("solve.launch"):
                g.graph.replay()
                g.pinned[n % 2].copy_(g.flag, non_blocking=True)
                g.events[n % 2].record()

        def read(n):
            with spans.host("solve.read"):
                g.events[n % 2].synchronize()
                return graphs.read(g.pinned[n % 2])

        _schedule(-(-cap // GRAPH_BLOCK), queue, read)
        with spans.host("solve.copy_out"), spans.device("solve.copy_out", device):
            return SolveState(*(t.clone() for t in g.state))

    def _capture(self, s: SolveState, p: Problem) -> _Graph:
        """Capture one block into a CUDA graph on static copies of (s, p).
        The static state is the block's input and, copied back at its end,
        its output; the flag is `live_any` of the result."""
        state = SolveState(*(t.clone() for t in s))
        problem = Problem(*(t.clone() for t in p))
        flag = torch.zeros((), dtype=torch.bool, device=s.J.device)

        def block():
            out = self.run_block(state, problem, GRAPH_BLOCK)
            for dst, src in zip(state, out):
                dst.copy_(src)
            flag.copy_(live_any(state))

        # the warm-up block's result is dropped
        graph = self.graph_captures.capture(block, warmup=lambda: self.run_block(state, problem, GRAPH_BLOCK))
        pinned = torch.zeros(2, dtype=torch.bool, pin_memory=True)
        events = (torch.cuda.Event(), torch.cuda.Event())
        return _Graph(graph, state, problem, flag, pinned, events)

    @property
    def captures(self) -> int:
        return self.graph_captures.count

    @property
    def capture_seconds(self) -> float:
        return self.graph_captures.seconds

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the solver's graph pool (0 before
        the first capture)."""
        return self.graph_captures.pool_bytes()

    def solution(self, s: SolveState) -> MPCSolution:
        dtype, device = s.J.dtype, s.J.device
        return MPCSolution(
            state_traj=s.Z[:, :NX].permute(2, 0, 1).contiguous(),
            control_traj=s.U.permute(2, 0, 1).contiguous(),
            cost=s.J,
            iterations=s.it,
            converged=s.done & torch.isfinite(s.J) & (s.J.abs() < 1e12),
            gains_K=s.KK.permute(3, 0, 1, 2).contiguous() if self.return_gains
            else torch.zeros((0,), dtype=dtype, device=device),
            grad_norm=s.pg,
            reg_final=s.reg,
            ls_evals=s.ls_n,
            status=s.st,
        )

    def __call__(self, x0, u_last, goal_pos, tra_pos, tra_ang, t,
                 U_init: Optional[torch.Tensor] = None, max_iters: Optional[int] = None,
                 drive: Optional[str] = None) -> MPCSolution:
        """max_iters: optional runtime iteration cap (default cfg.max_iters).
        drive: None (the solver's rule: eager where not `graphed`, the chain
        inside an enclosing capture, else the block graph's replays), or
        "eager", "blocks" or "chain" (`run_chain`'s drives)."""
        device = torch.as_tensor(x0).device
        if drive is None:
            drive = graphs.drive(device) if self.graphed(device) else "eager"
        with spans.host("solve.setup"), spans.device("solve.setup", device):
            s, p, cap = self.setup(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init, max_iters)
        if drive == "eager":
            s = self.run_eager(s, p, cap)
        else:
            with torch.no_grad():
                s = self.run_graph(s, p, cap) if drive == "graph" else self.run_chain(s, p, cap, drive)
        with spans.host("solve.solution"), spans.device("solve.solution", device):
            return self.solution(s)


def _card_counter(name: str, device) -> Optional[torch.Tensor]:
    """The spans counter `name` on a CUDA `device` where spans are on (else
    None), made at the first call, which a capture's warm-up makes outside
    it."""
    return spans.counter(name, device) if spans.on and torch.device(device).type == "cuda" else None


def grid_counter(device) -> Optional[torch.Tensor]:
    """The spans counter "ls.grid" on a card: [line searches on the grid that
    ran a trip, their trips]."""
    return _card_counter("ls.grid", device)


def glue_counter(device) -> Optional[torch.Tensor]:
    """The spans counter "ddp.glue" on a card: [DDP iterations that K6's
    `commit` ran with `go` true, the active lane-iterations among them]."""
    return _card_counter("ddp.glue", device)


def make_batched_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                        return_gains: bool = False) -> BatchedSolver:
    """The batched solver (`BatchedSolver`): solve(x0[B,13], u_last[B,4],
    goal[B,3], tra_pos[B,3], tra_ang[B,3], t[B], U_init=None|[B,H,4],
    max_iters=None) -> MPCSolution (leading B)."""
    return BatchedSolver(params, weights, cfg, return_gains=return_gains)
