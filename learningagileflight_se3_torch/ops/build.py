"""Build and bind the CUDA kernels of `csrc/`.

Every `.cu` file of `csrc/` is compiled by nvcc, for Hopper (`sm_90a`), into
one shared library with a plain C interface, bound with ctypes.  The build
runs at first use, keyed on a hash of the sources and flags, into
`build/kernels/` beside the package (listed in .gitignore); a fresh checkout
therefore builds everything on its first kernel launch.  Nothing here runs
at import time, so the CPU tests import this module without nvcc.

Each C entry point of K1 to K3 takes the launch constants as a
`KernelConsts` struct, the problem sizes, the tensors' device pointers and
the CUDA stream (K1's trial grid, `laf_rollout_trials_*`, the trial count
before H and B); K4's takes its pointers, its numbers and the stream
(`TSOLVE_ARGTYPES`), K5's its numbers, its pointers and the stream
(`LINE_SEARCH_ARGTYPES`), K6's a `GlueConsts` struct, its sizes, its
pointers and the stream (`GLUE_ARGTYPES`).  Each returns
`cudaGetLastError()` after the launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
GRAPH_IF_SOURCE = os.path.join(PKG_DIR, "utils", "graph_if.cu")
# f32 division and square root in their fast forms (within 2 ulp): the IEEE
# forms lengthen the chain of dependent work in every step of the backward
# sweep by a third.  f64 is untouched.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-prec-div=false", "-prec-sqrt=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
# name -> number of tensor pointers after (consts, H, B); the stream comes last
_ENTRY_POINTS = {
    "laf_rollout_f32": 12, "laf_rollout_f64": 12,
    "laf_riccati_fused_f32": 15, "laf_riccati_fused_f64": 15,
    "laf_riccati_unfused_f32": 18, "laf_riccati_unfused_f64": 18,
}
# K4's entry points (csrc/tsolve.cu): the lane inputs and DNN2's parameters
# (11 pointers), tol, max_iters, secant, B, then t, count, fused, scratch and
# the stream
TSOLVE_ENTRY_POINTS = ("laf_tsolve_f32", "laf_tsolve_f64")
TSOLVE_ARGTYPES = [_p] * 11 + [ctypes.c_double, _i, _i, _i] + [_p] * 4 + [_p]
# K1 over a grid of trials (csrc/rollout.cu): consts, T, H, B, K1's 12
# pointers, the stream (ROLLOUT_TRIALS_ARGTYPES, after KernelConsts)
ROLLOUT_TRIALS_ENTRY_POINTS = ("laf_rollout_trials_f32", "laf_rollout_trials_f64")
# K5 (csrc/line_search.cu): T, H, B, n_alpha, stride, n_deep, 12 inputs, 6
# outputs, count, the stream
LINE_SEARCH_ENTRY_POINTS = ("laf_line_search_f32", "laf_line_search_f64")
LINE_SEARCH_ARGTYPES = [_i] * 6 + [_p] * 19 + [_p]


class KernelConsts(ctypes.Structure):
    """Model constants passed by value at every launch; the layout mirrors
    `laf::Consts` in csrc/lane_algebra.cuh (20 doubles, then 4 ints)."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "Jx", "Jy", "Jz", "mass", "l", "c", "g",
        "wrt", "wqt", "wthrust", "wrf", "wvf", "wqf", "wwf", "w_du",
        "dt", "lb", "ub", "w_bound", "w_bound_weight",
    )] + [(n, ctypes.c_int) for n in (
        "squared_attitude", "use_wqf", "use_ddp", "boxqp_iters",
    )]


ROLLOUT_TRIALS_ARGTYPES = [ctypes.POINTER(KernelConsts), _i, _i, _i] + [_p] * 12 + [_p]


class GlueConsts(ctypes.Structure):
    """K6's solver settings, passed by value at every launch (ops/ddp_glue.py
    `glue_consts`); the layout mirrors `laf::GlueConsts` in csrc/ddp_glue.cu
    (12 doubles, then 8 ints)."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "tol", "gtol", "stall_gtol", "reg_shrink", "reg_min", "reg_grow", "reg_cap", "reg_max",
        "wrf2", "wvf2", "wwf2", "wqf",
    )] + [(n, ctypes.c_int) for n in (
        "n_alpha", "stride", "n_deep", "n_trials", "escalate", "no_progress_iters", "ls_adaptive", "use_wqf",
    )]


# K6 (csrc/ddp_glue.cu), each entry point after GlueConsts: prepare H, B, 6
# pointers; decide B, 12 pointers; commit H, B, 42 pointers; the stream last
_GC = ctypes.POINTER(GlueConsts)
GLUE_ARGTYPES = {
    "prepare": [_GC, _i, _i] + [_p] * 6 + [_p],
    "decide": [_GC, _i] + [_p] * 12 + [_p],
    "commit": [_GC, _i, _i] + [_p] * 42 + [_p],
}
GLUE_ENTRY_POINTS = {f"laf_glue_{step}_{t}": types for step, types in GLUE_ARGTYPES.items() for t in ("f32", "f64")}


def kernel_consts(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                  boxqp_iters: int, use_ddp: bool) -> KernelConsts:
    return KernelConsts(
        params.Jx, params.Jy, params.Jz, params.mass, params.l, params.c, params.g,
        weights.wrt, weights.wqt, weights.wthrust, weights.wrf, weights.wvf,
        weights.wqf, weights.wwf, weights.w_du,
        cfg.dt, cfg.u_lb, cfg.u_ub, cfg.w_bound, cfg.w_bound_weight,
        int(weights.squared_attitude), int(weights.wqf != 0.0), int(use_ddp),
        int(boxqp_iters),
    )


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an up-to-date build was found
    ptxas_log: str        # nvcc -Xptxas -v output: registers, stack, spills


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return nvcc


def _sources():
    names = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, n) for n in names]


def _build(srcs, stem: str):
    """(ctypes library, path, build seconds, ptxas log) of `srcs` built by
    nvcc into BUILD_DIR, keyed on a hash of the sources and flags (0.0
    seconds when an up-to-date build was found); raises if nvcc fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    tag = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    log_path = so[:-3] + ".log"
    seconds = 0.0
    if not os.path.exists(so):
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        seconds = time.perf_counter() - t0
    with open(log_path) as f:
        ptxas_log = f.read()
    return ctypes.CDLL(so), so, seconds, ptxas_log


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc fails."""
    lib, so, seconds, ptxas_log = _build(_sources(), "laf_kernels")
    for name, n_ptr in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(KernelConsts), _i, _i] + [_p] * n_ptr + [_p]
        fn.restype = _i
    for name in TSOLVE_ENTRY_POINTS:
        getattr(lib, name).argtypes = TSOLVE_ARGTYPES
        getattr(lib, name).restype = _i
    for name in ROLLOUT_TRIALS_ENTRY_POINTS:
        getattr(lib, name).argtypes = ROLLOUT_TRIALS_ARGTYPES
        getattr(lib, name).restype = _i
    for name in LINE_SEARCH_ENTRY_POINTS:
        getattr(lib, name).argtypes = LINE_SEARCH_ARGTYPES
        getattr(lib, name).restype = _i
    for name, argtypes in GLUE_ENTRY_POINTS.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _i
    for name in ("laf_rollout_ring_bytes", "laf_riccati_unfused_smem_bytes", "laf_tsolve_smem_bytes",
                 "laf_line_search_max_lanes"):
        getattr(lib, name).argtypes = [_i]
        getattr(lib, name).restype = _i
    return KernelLibrary(lib, so, seconds, ptxas_log)


@functools.cache
def graph_library() -> KernelLibrary:
    """Build (if needed) and load utils/graph_if.cu: the CUDA-graph
    conditional nodes of utils/graphs.py and the clock stamp of
    utils/profiling.py's spans (no kernel of the solver's own)."""
    lib, so, seconds, ptxas_log = _build([GRAPH_IF_SOURCE], "laf_graph_if")
    lib.laf_if_begin.argtypes = [_p, _p, _p]
    lib.laf_if_begin.restype = _i
    lib.laf_if_end.argtypes = [_p]
    lib.laf_if_end.restype = _i
    lib.laf_stamp.argtypes = [_p, _p, ctypes.c_longlong, ctypes.c_longlong, _p]
    lib.laf_stamp.restype = _i
    return KernelLibrary(lib, so, seconds, ptxas_log)


def check_tensors(op: str, shapes: dict, tensors: dict):
    """Every tensor on one device, one float dtype (f32/f64), of the given
    shape, and contiguous.  Returns (device, dtype)."""
    first = next(iter(tensors.values()))
    device, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{op}: dtype {dtype} (float32 or float64 only)")
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{op}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {device}")
    return device, dtype


def launch(name: str, dtype, consts: KernelConsts, H: int, B: int, tensors, device):
    """Launch `name`_f32/_f64 on the current stream of `device`; raise on a
    nonzero cudaGetLastError()."""
    fn = getattr(library().lib, f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.byref(consts), H, B, *[t.data_ptr() for t in tensors], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
