"""The CUDA sources of the PyTorch port, checked on the CPU.

There is no nvcc here, so the kernels of learningagileflight_se3_torch/csrc
are checked in two other ways; neither replaces the card's tests
(tests/test_torch_gpu.py), which hold the nvcc build against the plain
versions:

  - parse: libclang parses each .cu as CUDA for sm_90a, device and host side,
    with a stub of the few runtime declarations they use, and every template
    instance the C entry points reach is checked;
  - emulation: g++ compiles the sources with one std::thread per CUDA thread
    (__syncwarp / __syncthreads as barriers, __shfl_sync through memory,
    cp.async as a copy that lands only at the cp.async.wait_group that
    retires its group, dynamic shared memory filled with NaN before each
    block, blocks one after another), and the kernels, called through their
    C entry points on CPU tensors, are held against their plain PyTorch
    versions in f64 at batch sizes that exercise the ragged edges (1, 5,
    20, 33 lanes); K4 against the t-solver's eager loop, in f64 and f32.
    This checks the kernels' indexing, barriers and masking, not the CUDA
    compiler's code or the card's numerics.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.ops import build, riccati_fused, riccati_unfused, rollout
from learningagileflight_se3_torch.ops.inputs import (
    as_tensors, backward_inputs, main_path_inputs, rollout_inputs, with_failing_lanes,
)
from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3_torch.utils.weights import load_dnn2

SOURCES = sorted(n for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu"))

# the runtime declarations the sources use, for both checks
_DECLS = """
struct uint3 { unsigned x, y, z; };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorLaunchFailure = 719 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
"""

PARSE_STUB = """#pragma once
typedef unsigned long size_t;
#define __host__ __attribute__((host))
#define __device__ __attribute__((device))
#define __global__ __attribute__((global))
#define __shared__ __attribute__((shared))
#define __forceinline__ __inline__ __attribute__((always_inline))
#define __launch_bounds__(...) __attribute__((launch_bounds(__VA_ARGS__)))
#define __align__(n) __attribute__((aligned(n)))
""" + _DECLS + """
struct dim3 { unsigned x, y, z; __host__ __device__ dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern const __device__ uint3 threadIdx, blockIdx;
extern const __device__ dim3 blockDim;
cudaError_t cudaGetLastError();
cudaError_t cudaConfigureCall(dim3, dim3, size_t = 0, cudaStream_t = 0);
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int);
__device__ void __syncwarp(unsigned = 0xffffffffu);
__device__ void __syncthreads();
__device__ float __shfl_sync(unsigned, float, int, int = 32);
__device__ double __shfl_sync(unsigned, double, int, int = 32);
__device__ size_t __cvta_generic_to_shared(const void*);
__device__ float sqrt(float); __device__ double sqrt(double);
__device__ float fabs(float); __device__ double fabs(double);
__device__ bool isnan(float); __device__ bool isnan(double);
__device__ int min(int, int);
__device__ float cosf(float); __device__ double cos(double);
__device__ float sinf(float); __device__ double sin(double);
__device__ float atanf(float); __device__ double atan(double);
__device__ bool isfinite(float); __device__ bool isfinite(double);
__device__ int atomicAdd(int*, int); __device__ int atomicMax(int*, int); __device__ int atomicExch(int*, int);
__device__ void __threadfence();
__host__ __device__ inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
__host__ __device__ inline double2 make_double2(double a, double b) { return {a, b}; }
"""

EMU_HEADER = """#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __host__
#define __device__
#define __global__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
""" + _DECLS + """
inline thread_local uint3 threadIdx, blockIdx, blockDim;
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return cudaSuccess; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
using std::fabs; using std::isfinite; using std::isnan; using std::min; using std::sqrt;
// atomics: only a block's thread 0 calls them, and blocks run one after another
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicExch(int* p, int v) { return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST); }
inline int atomicMax(int* p, int v) { int o = *p; *p = o > v ? o : v; return o; }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
namespace emu {
struct Block {  // one block's barriers and shuffle slots, shared by its threads
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  double xchg[1024];
};
inline thread_local Block* blk;
// Dynamic shared memory, every kernel's: filled with NaN bytes before each
// block, so that a read of a slot no copy has filled is caught.
alignas(128) inline unsigned char dyn_smem[1 << 18];
// cp.async: a thread's copies are queued in groups and land when a
// cp.async.wait_group retires their group, not before.
struct Copy { void* dst; const void* src; int bytes; };
inline thread_local std::vector<Copy> open_group;
inline thread_local std::deque<std::vector<Copy>> groups;
inline std::atomic<bool> copies_left{false};  // a block ended with copies in flight
inline void cp_async(void* dst, const void* src, int bytes) { open_group.push_back({dst, src, bytes}); }
inline void commit() { groups.push_back(std::move(open_group)); open_group.clear(); }
inline void wait(int n) {
  while ((int)groups.size() > n) {
    for (const Copy& c : groups.front()) std::memcpy(c.dst, c.src, c.bytes);
    groups.pop_front();
  }
}
// blocks one after another (so a kernel's static shared memory, a function
// static here, is its block's), each thread of a block an std::thread
inline void launch(int grid, int block, std::function<void()> body) {
  for (int g = 0; g < grid; ++g) {
    Block B;
    B.all = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < (block + 31) / 32; ++w)
      B.warp.push_back(std::make_unique<std::barrier<>>(std::min(32, block - 32 * w)));
    std::memset(dyn_smem, 0xff, sizeof dyn_smem);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {unsigned(t), 0, 0}; blockIdx = {unsigned(g), 0, 0}; blockDim = {unsigned(block), 1, 1};
        blk = &B;
        body();
        bool left = !open_group.empty();
        for (const auto& grp : groups) left = left || !grp.empty();
        if (left) copies_left = true;
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace emu
inline cudaError_t cudaGetLastError() { return emu::copies_left.exchange(false) ? cudaErrorLaunchFailure : cudaSuccess; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::blk->warp[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncthreads() { emu::blk->all->arrive_and_wait(); }
template <class T> T __shfl_sync(unsigned, T v, int src, int = 32) {
  emu::blk->xchg[threadIdx.x] = (double)v;
  __syncwarp();
  T r = (T)emu::blk->xchg[threadIdx.x / 32 * 32 + src];
  __syncwarp();
  return r;
}
"""


def _emulation_source(text):
    """A .cu/.cuh text rewritten for EMU_HEADER: launches as emu::launch,
    cp.async as a copy deferred to the wait that retires its group, any
    kernel's dynamic shared memory the emulation's buffer."""
    text = text.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    text = re.sub(r"(\w+<[^;<>]*>)<<<([^,]+),([^,]+),[^>]*>>>\((.*?)\);",
                  lambda m: f"emu::launch({m.group(2)}, {m.group(3)}, [&] {{ {m.group(1)}({m.group(4)}); }});",
                  text, flags=re.S)
    text = re.sub(r"(void cp_async\(void\* smem, const void\* gmem\) \{).*?\n\}\n",
                  r"\1 emu::cp_async(smem, gmem, BYTES); }\n", text, flags=re.S)
    text = re.sub(r"(void cp_async_(commit|wait)\(\) \{).*?\n\}\n",
                  lambda m: m.group(1) + (" emu::commit(); }\n" if m.group(2) == "commit" else " emu::wait(N); }\n"),
                  text, flags=re.S)
    return re.sub(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                  r"unsigned char* \1 = emu::dyn_smem;", text)


@pytest.mark.parametrize("source", SOURCES)
def test_cuda_source_parses_for_sm90a(source, tmp_path):
    cindex = pytest.importorskip("clang.cindex")
    (tmp_path / "cuda_runtime.h").write_text(PARSE_STUB)
    index = cindex.Index.create()
    errors = []
    for side in ("--cuda-device-only", "--cuda-host-only"):
        tu = index.parse(os.path.join(build.CSRC_DIR, source), args=[
            "-x", "cuda", side, "--cuda-gpu-arch=sm_90a", "-nocudainc", "-nocudalib", "-std=c++17",
            f"-I{tmp_path}"])
        errors += [f"{side} {d.location.line}: {d.spelling}" for d in tu.diagnostics if d.severity >= 3]
    assert not errors, errors


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built with g++ for the CPU emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emulated_kernels")
    (out / "emu.h").write_text(EMU_HEADER)
    cpps = []
    for name in os.listdir(build.CSRC_DIR):
        text = _emulation_source(open(os.path.join(build.CSRC_DIR, name)).read())
        target = out / (name[:-3] + ".cpp" if name.endswith(".cu") else name)
        target.write_text(text)
        cpps += [str(target)] if name.endswith(".cu") else []
    so = out / "libemulated.so"
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-o", str(so),
                           *cpps], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, n_ptr in build._ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(build.KernelConsts), ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * (n_ptr + 1)
        fn.restype = ctypes.c_int
    for name in build.TSOLVE_ENTRY_POINTS:
        getattr(lib, name).argtypes = build.TSOLVE_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _call(lib, name, consts, H, B, tensors):
    assert getattr(lib, name + "_f64")(ctypes.byref(consts), H, B, *[t.data_ptr() for t in tensors], None) == 0


def _sweep_close(out, ref, tol):
    for nm, a, b in zip(["kk", "KK", "dV1", "dV2", "fail", "pg"], out, ref):
        a, b = a.double().numpy(), b.double().numpy()
        assert (np.isnan(a) == np.isnan(b)).all(), nm
        both = np.isfinite(a) & np.isfinite(b)
        err = float(np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2), initial=0.0))
        assert err < tol, (nm, err)


def _k2(lib, args, P, W, C):
    H, _, B = args[0].shape
    out = [torch.full((H, 4, B), np.nan, dtype=torch.float64), torch.full((H, 4, 17, B), np.nan, dtype=torch.float64)]
    out += [torch.full((B,), np.nan, dtype=torch.float64) for _ in range(4)]
    _call(lib, "laf_riccati_fused", build.kernel_consts(P, W, C, C.boxqp_iters, C.use_ddp), H, B, args + out)
    return out[:4] + [out[4] > 0, out[5]]


VARIANTS = {
    "default": (dict(), dict()),
    "pybullet": (dict(squared_attitude=False), dict(u_ub=2.4)),
    "wqf_wbound": (dict(wqf=2.0), dict(w_bound_weight=3.0, w_bound=0.3)),
}


@pytest.mark.parametrize("B", [1, 5, 20, 33])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_emulated_kernels_match_plain(emulated, variant, B):
    """K1 and K2 (f64, random inputs, H=6) against their plain versions."""
    wkw, skw = VARIANTS[variant]
    H = 6
    P, W, C = QuadParams(), CostWeights(**wkw), SolverConfig(horizon=H, **skw)
    a2 = as_tensors(backward_inputs(H, B, seed=B))
    _sweep_close(_k2(emulated, a2, P, W, C), riccati_fused.riccati_backward_plain(*a2, P, W, C), 1e-9)
    a1 = as_tensors(rollout_inputs(H, B, seed=B))
    out = [torch.full((H, 17, B), np.nan, dtype=torch.float64), torch.full((H, 4, B), np.nan, dtype=torch.float64),
           torch.full((B,), np.nan, dtype=torch.float64)]
    _call(emulated, "laf_rollout", build.kernel_consts(P, W, C, C.boxqp_iters, C.use_ddp), H, B, a1 + out)
    for a, b in zip(out, rollout.rollout_forward_plain(*a1, P, W, C)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def _k3(lib, derivs, P, C, use_ddp):
    H, B = derivs[0].shape[0], derivs[0].shape[-1]
    out = [torch.full((H, 4, B), np.nan, dtype=torch.float64), torch.full((H, 4, 17, B), np.nan, dtype=torch.float64)]
    out += [torch.full((B,), np.nan, dtype=torch.float64) for _ in range(4)]
    _call(lib, "laf_riccati_unfused", build.kernel_consts(P, CostWeights(), C, C.boxqp_iters, use_ddp), H, B,
          list(derivs) + out)
    return out[:4] + [out[4] > 0, out[5]]


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("B", [1, 5, 20, 33])
def test_emulated_unfused_kernel_matches_plain(emulated, B, use_ddp):
    """K3 (f64, random inputs through derivatives_plain, H=6) against its
    plain version: one block of 8 scenarios or several, ragged, with the
    16-byte copies (B=20) and the one-value copies (B=1, 5, 33)."""
    H = 6
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
    derivs = riccati_unfused.derivatives_plain(*as_tensors(backward_inputs(H, B, seed=B)), P, W, C)
    ref = riccati_unfused.riccati_unfused_plain(*derivs, P, C.dt, C.u_lb, C.u_ub, C.boxqp_iters, use_ddp)
    _sweep_close(_k3(emulated, derivs, P, C, use_ddp), ref, 1e-9)


@pytest.mark.parametrize("B", [5, 33])
def test_emulated_unfused_kernel_fail_pattern(emulated, B):
    """K3 where some lanes fail the pivot test (ops/inputs.py
    with_failing_lanes): the first and last scenario of the batch and one
    between, so that the scalar lane's factor crosses shared memory to the
    column workers of a failing scenario beside passing ones."""
    H = 6
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
    lanes = sorted({0, B // 2, B - 1})
    derivs = riccati_unfused.derivatives_plain(*as_tensors(backward_inputs(H, B, seed=B)), P, W, C)
    derivs = with_failing_lanes(derivs, lanes, C.u_lb, C.u_ub)
    ref = riccati_unfused.riccati_unfused_plain(*derivs, P, C.dt, C.u_lb, C.u_ub, C.boxqp_iters, True)
    assert bool(ref[4][lanes].all()) and not bool(ref[4].all())
    out = _k3(emulated, derivs, P, C, True)
    assert torch.equal(out[4], ref[4])
    _sweep_close(out, ref, 1e-9)


def test_emulated_kernels_on_solver_trajectories(emulated):
    """K1, K2 and K3 at the full horizon (H=50, B=20, f64) on the solver's
    own trajectories (ops/inputs.py main_path_inputs)."""
    H, B = 50, 20
    P, W, C = QuadParams(), CostWeights(), SolverConfig(horizon=H)
    k1, k2 = main_path_inputs(H, B, iters=4)
    _sweep_close(_k2(emulated, k2, P, W, C), riccati_fused.riccati_backward_plain(*k2, P, W, C), 1e-9)
    derivs = riccati_unfused.derivatives_plain(*k2, P, W, C)
    ref = riccati_unfused.riccati_unfused_plain(*derivs, P, C.dt, C.u_lb, C.u_ub, 6, True)
    _sweep_close(_k3(emulated, derivs, P, C, True), ref, 1e-9)
    out = [torch.full((H, 17, B), np.nan, dtype=torch.float64), torch.full((H, 4, B), np.nan, dtype=torch.float64),
           torch.full((B,), np.nan, dtype=torch.float64)]
    _call(emulated, "laf_rollout", build.kernel_consts(P, W, C, C.boxqp_iters, C.use_ddp), H, B, k1 + out)
    ref = rollout.rollout_forward_plain(*k1, P, W, C)
    sane = torch.isfinite(ref[2]) & (ref[2].abs() < 1e12)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a[..., sane], b[..., sane], rtol=1e-9, atol=1e-12)


# (tol, max_iters) for each update: some lanes converge before the cap, at
# different iterations, and some meet it
K4_CASES = {"reference": (1e-4, 14), "secant": (1e-9, 3)}


@torch.no_grad()
def _at_its_fixed_point(lane, r):
    """The lane's state with its position moved along a line from the
    gate's centroid (the first of a few random directions on which DNN2's
    answer less the guess changes sign; bisection on the distance) until
    the guess |centroid - position| / 3 is DNN2's own answer within 1e-7."""
    solver = make_traversal_time_solver(load_dnn2().double())
    c = lane[2].mean(dim=0)

    def gap(away, s):
        st = lane[0].clone()
        st[0:3] = c + s * away
        t0 = torch.linalg.vector_norm(s * away) / 3.0
        return float(solver._predict(st, lane[1], lane[2], lane[3], lane[4], t0) - t0), st

    for _ in range(20):
        away = torch.tensor(r.normal(size=3) + [0.0, -3.0, 0.0])
        grid = np.linspace(0.02, 3.0, 60)
        signs = [gap(away, s)[0] > 0 for s in grid]
        hit = [i for i in range(59) if signs[i] != signs[i + 1]]
        if hit:
            lo, hi = grid[hit[0]], grid[hit[0] + 1]
            while hi - lo > 1e-13:
                mid = 0.5 * (lo + hi)
                lo, hi = (mid, hi) if (gap(away, mid)[0] > 0) == signs[hit[0]] else (lo, mid)
            g, st = gap(away, lo)
            assert abs(g) < 1e-7
            return st
    raise AssertionError("no fixed point on the lines tried")


def _k4_inputs(B, seed):
    """B flight situations along the approach to a moving gate.  From 5
    lanes on, lane 1's state is not finite and lane 2 starts at its fixed
    point (`_at_its_fixed_point`), with lane 0's pitch rate."""
    r = np.random.default_rng(seed)
    state = np.zeros((B, 13))
    state[:, 0:3] = r.normal(size=(B, 3)) * [1.5, 0.5, 0.8] + [0.0, -6.0, 0.0]
    state[:, 1] += np.linspace(0.0, 5.0, B)
    state[:, 3:6] = r.normal(size=(B, 3)) + [0.0, 2.0, 0.0]
    q = r.normal(size=(B, 4)) * 0.2
    q[:, 0] += 1.0
    state[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    final = r.normal(size=(B, 3)) + [0.0, 6.0, 0.0]
    pts = np.array([[-0.5, 0.0, 1.0], [0.5, 0.0, 1.0], [0.5, 0.0, -1.0], [-0.5, 0.0, -1.0]])
    pts = pts[None] + r.normal(size=(B, 1, 3)) * 0.5
    velo = np.array([1.0, 0.3, 0.4]) + r.normal(size=(B, 3)) * 0.1
    w = np.pi / 2 + r.normal(size=B) * 0.2
    args = [torch.tensor(a) for a in (state, final, pts, velo, w)]
    if B >= 5:
        args[0][1, 0] = np.nan
        args[4][2] = args[4][0]  # the pitch rate the test passes as a number
        args[0][2] = _at_its_fixed_point([a[2] for a in args], r)
    return args


@pytest.mark.parametrize("accel", list(K4_CASES))
@pytest.mark.parametrize("B", [1, 5, 20, 33])
def test_emulated_tsolve_matches_the_eager_loop(emulated, B, accel):
    """K4 through both C entry points against the t-solver's eager loop on
    the same lanes: t in f64 within 1e-9 and in f32 within 1e-3 (its f32
    rounding against torch's on the CPU, at a cap that binds); in f64 the
    batch's count is the eager loop's `it`, the lane-iterations of
    `tsolve.fused` are the sum of each lane's own count (the eager loop on
    that lane alone), a lane that starts converged and a lane whose state is
    not finite keep the guess, and the scratch is left zero.  The pitch rate
    is a number at B=1 and 20, a tensor at 5 and 33; B=1 is the tick's call,
    with no batch dimension."""
    tol, cap = K4_CASES[accel]
    args = _k4_inputs(B, seed=B)
    w = float(args[4][0]) if B in (1, 20) else args[4]
    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        solver = make_traversal_time_solver(load_dnn2().to(dtype), tol=tol, max_iters=cap, accel=accel)
        lanes = [a.to(dtype) for a in args[:4]] + [w if isinstance(w, float) else w.to(dtype)]
        if B == 1:  # the tick's call: no batch dimension
            lanes = [a[0] for a in lanes[:4]] + [w]
        solver.count = torch.zeros(2, dtype=torch.int32)
        want = solver(*lanes)
        it = int(solver.count[1])
        t = torch.full((B,), np.nan, dtype=dtype)
        count, fused, scratch = (torch.zeros(2, dtype=torch.int32) for _ in range(3))
        fn = getattr(emulated, f"laf_tsolve_{'f64' if dtype == torch.float64 else 'f32'}")
        kernel_args = solver.kernel_args(*lanes)  # held: the pointers are its tensors'
        assert fn(*[a.data_ptr() for a in kernel_args], tol, cap, int(accel == "secant"), B,
                  t.data_ptr(), count.data_ptr(), fused.data_ptr(), scratch.data_ptr(), None) == 0
        torch.testing.assert_close(t.reshape(want.shape), want, rtol=0, atol=atol, equal_nan=True)
        assert scratch.tolist() == [0, 0] and fused[0] == 1 and count[0] == 0
        if dtype == torch.float32:
            assert 0 < count[1] <= cap and count[1] <= fused[1] <= B * count[1]
            continue
        own = []
        for i in range(B):
            solver.count.zero_()
            solver(*[a[i] if B > 1 else a for a in lanes[:4]], w if isinstance(w, float) else w[i])
            own.append(int(solver.count[1]))
        assert count.tolist() == [0, it] and it == max(own) and int(fused[1]) == sum(own)
        if B >= 5:
            guess = torch.linalg.vector_norm(lanes[2][2].mean(dim=0) - lanes[0][2, 0:3]) / 3.0
            assert own[1] == own[2] == 0 and torch.isnan(t[1]) and abs(float(t[2] - guess)) < 1e-12
        if B >= 20:
            assert max(own) == cap and min(own[3:]) < cap
