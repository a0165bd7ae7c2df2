"""K4: the traversal-time fixed point over DNN2, whole, on the card.

Replaces no TPU kernel: the JAX package's `sim/tsolver.py` runs its
`lax.while_loop`s through XLA.  On the card the port ran them as PyTorch
ops in conditional CUDA-graph nodes, about 170 small kernels a DNN2
evaluation, bound by the wait between dependent kernels.  K4 runs the
guess, the seed evaluation(s), every iteration and the test in one launch:
a block of 128 threads a lane, thread j holding DNN2's row j of layers 1
and 2, every thread computing the lane's window geometry itself, output 6
summed by warp shuffles (`csrc/tsolve.cu`).  Its plain version, and the
CPU's path, is `sim/tsolver.py` `TraversalTimeSolver`'s eager loop.

Layout: state (B, 13), final (B, 3), pts (B, 4, 3), velo (B, 3), w (B,), DNN2's
parameters as `nn.Linear` holds them, all of one dtype, contiguous -> t (B,).
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.ops import build

DNN2_SHAPES = [(128, 18), (128,), (128, 128), (128,), (7, 128), (7,)]

launches = 0  # kernel launches


def dnn2_params(model2, dtype) -> list:
    """DNN2's weights and biases in `dtype` (the parameters themselves where
    they are of it, so that values written in place are seen)."""
    ps = [p.detach() for p in model2.parameters()]
    if [tuple(p.shape) for p in ps] != DNN2_SHAPES:
        raise ValueError(f"K4 takes DNN2 18-128-128-7, not {[tuple(p.shape) for p in ps]}")
    return [p.to(dtype).contiguous() for p in ps]


def _counter(name, c, device):
    if c is not None and (c.dtype != torch.int32 or c.shape != (2,) or c.device != device):
        raise ValueError(f"traversal_time: {name} must be an int32 (2,) tensor on {device}")
    return c


def traversal_time(state, final, pts, velo, w, params, tol: float, max_iters: int, secant: bool,
                   count=None, fused=None, scratch=None):
    """K4 on the current stream: t (B,).  count, fused (int32 (2,) or None)
    get [0, the batch's iterations] and [1, the lanes' iterations summed];
    with count, scratch is an int32 (2,) zero tensor of the caller's, which
    the kernel leaves zero."""
    global launches
    B = state.shape[0]
    tensors = dict(state=state, final=final, pts=pts, velo=velo, w=w,
                   **{f"p{i}": p for i, p in enumerate(params)})
    shapes = dict(state=(B, 13), final=(B, 3), pts=(B, 4, 3), velo=(B, 3), w=(B,),
                  **{f"p{i}": s for i, s in enumerate(DNN2_SHAPES)})
    device, dtype = build.check_tensors("traversal_time", shapes, tensors)
    if device.type != "cuda":
        raise ValueError("traversal_time: K4 runs on the card (the CPU's path is sim/tsolver.py's eager loop)")
    count, fused, scratch = (_counter(n, c, device) for n, c in (("count", count), ("fused", fused),
                                                                  ("scratch", scratch)))
    if count is not None and scratch is None:
        raise ValueError("traversal_time: a count needs its scratch")
    t = torch.empty((B,), dtype=dtype, device=device)
    fn = getattr(build.library().lib, f"laf_tsolve_{'f64' if dtype == torch.float64 else 'f32'}")
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        rc = fn(*[a.data_ptr() for a in tensors.values()], float(tol), int(max_iters), int(secant), B,
                t.data_ptr(), ptr(count), ptr(fused), ptr(scratch), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"traversal_time: CUDA launch failed with cudaError {rc}")
    launches += 1
    return t


def smem_bytes(dtype) -> int:
    """The kernel's dynamic shared memory per block."""
    return build.library().lib.laf_tsolve_smem_bytes(int(dtype == torch.float64))
