// K4: the traversal-time fixed point over DNN2, whole, one block a lane.
//
// Replaces no TPU kernel: the JAX package runs learningagileflight_se3_tpu/
// sim/tsolver.py's two lax.while_loops through XLA, whose fusions make an
// iteration a few device ops.  The port ran them as PyTorch ops inside
// conditional IF nodes of a CUDA graph, about 170 small kernels a DNN2
// evaluation, each waiting for the one before.  Plain PyTorch version (and
// the CPU's path): sim/tsolver.py TraversalTimeSolver's eager loop.
//
// Bound on the H100.  An iteration is one DNN2 evaluation a lane (18-128-128,
// then output 6 alone: about 19,000 FMAs) and the window geometry before it
// (about 300 flops, a sin, a cos, an atan, two square roots): at B=128 with
// every lane at 80 iterations about 0.4 GFLOP, 6 us at 67 TFLOP/s f32 (the
// flight's lanes average far fewer); the bytes, DNN2 (77 KB f32) and 33
// values a lane, take under 0.1 us at 3.35 TB/s.  What bounds it is the
// slowest lane's chain of dependent iterations (0.85 us each on an H100), so:
//  - a block of 128 threads a lane, thread j holding row j of DNN2's layers
//    1 and 2 (layer 2's row in registers in f32, its transpose in shared
//    memory in f64, where a row does not fit): layer 1 is 18 FMAs a thread,
//    layer 2 128, in four partial sums;
//  - every thread computes the lane's window geometry itself, the same
//    instructions on the same values, so the 18 inputs need no barrier;
//  - output 6 is one 128-term dot product, summed by a butterfly of warp
//    shuffles (every lane of a warp ends with the same sum) and then across
//    the 4 warps in a fixed order: every thread holds the same t, and every
//    branch of the update is uniform across the block;
//  - two barriers an evaluation, no host and no other kernel in the loop.
// A lane loops while it is live and its own count is under max_iters, which
// is the batched loop's result lane by lane: a converged lane keeps its t, a
// lane whose t or DNN2 output is not finite fails the test at once, and the
// batch's count (added to `count[1]`) is the largest lane count.
//
// Layout: state (B, 13), final (B, 3), pts (B, 4, 3), velo (B, 3), w (B,),
// DNN2 as nn.Linear holds it (W1 (128, 18), b1, W2 (128, 128), b2, W3 (7,
// 128), b3), t (B,).  count (int32 [2], or null) gets [0, the batch's
// iterations], fused (int32 [2], or null) [1, the lanes' iterations summed];
// scratch (int32 [2], zero, and left zero) serves count's maximum.
#include <cuda_runtime.h>

namespace laf {

constexpr int K4_HID = 128;  // DNN2's width, and the threads of a block
constexpr int K4_IN = 18;    // DNN2's inputs
// a lane's inputs in shared memory: state 13, final 3, corners 12, velocity 3, w
constexpr int L_FIN = 13, L_PTS = 16, L_VEL = 28, L_W = 31, K4_LANE = 32;

__device__ __forceinline__ float k4_cos(float x) { return cosf(x); }
__device__ __forceinline__ double k4_cos(double x) { return cos(x); }
__device__ __forceinline__ float k4_sin(float x) { return sinf(x); }
__device__ __forceinline__ double k4_sin(double x) { return sin(x); }
__device__ __forceinline__ float k4_atan(float x) { return atanf(x); }
__device__ __forceinline__ double k4_atan(double x) { return atan(x); }

// torch.relu and clamp_min(x, 0): a NaN stays NaN
template <typename T>
__device__ __forceinline__ T k4_relu(T x) { return x < T(0) ? T(0) : x; }

// torch.clamp: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T k4_clamp(T x, T lo, T hi) { return x < lo ? lo : (x > hi ? hi : x); }

template <typename T>
__device__ __forceinline__ T k4_norm3(T x, T y, T z) { return sqrt(x * x + y * y + z * z); }

// geometry/gate.py window_inputs(rotate_y(translate(pts, v t), w t), state,
// final) for the lane in `ln` (shared memory), as torch computes it.
template <typename T>
__device__ __forceinline__ void k4_window(const T* ln, T t, T (&x)[K4_IN]) {
  T q[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) q[i][k] = ln[L_PTS + 3 * i + k] + ln[L_VEL + k] * t;
  // rotate_y about the centroid by w t
  T c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = (((q[0][k] + q[1][k]) + q[2][k]) + q[3][k]) / T(4);
  const T a = ln[L_W] * t, ca = k4_cos(a), sa = k4_sin(a);
  T p[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T rx = q[i][0] - c[0], ry = q[i][1] - c[1], rz = q[i][2] - c[2];
    p[i][0] = (ca * rx - sa * rz) + c[0];
    p[i][1] = ry + c[1];
    p[i][2] = (sa * rx + ca * rz) + c[2];
  }
  // gate_frame: rows ax, ay, az; ay the unit normal, ax = ay x [0, 0, 1]
  const T e1x = p[1][0] - p[0][0], e1y = p[1][1] - p[0][1], e1z = p[1][2] - p[0][2];
  const T e2x = p[2][0] - p[1][0], e2y = p[2][1] - p[1][1], e2z = p[2][2] - p[1][2];
  const T nx = e1y * e2z - e1z * e2y, ny = e1z * e2x - e1x * e2z, nz = e1x * e2y - e1y * e2x;
  const T nn = k4_norm3(nx, ny, nz);
  const T R[3][3] = {{ny / nn, -(nx / nn), T(0)}, {nx / nn, ny / nn, nz / nn}, {T(0), T(0), T(1)}};
  T g[3];  // the rotated corners' centroid
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = (((p[0][k] + p[1][k]) + p[2][k]) + p[3][k]) / T(4);
  const T dr[3] = {ln[0] - g[0], ln[1] - g[1], ln[2] - g[2]};
  const T df[3] = {ln[L_FIN] - g[0], ln[L_FIN + 1] - g[1], ln[L_FIN + 2] - g[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = R[i][0] * dr[0] + R[i][1] * dr[1] + R[i][2] * dr[2];
    x[3 + i] = R[i][0] * ln[3] + R[i][1] * ln[4] + R[i][2] * ln[5];
    x[13 + i] = R[i][0] * df[0] + R[i][1] * df[1] + R[i][2] * df[2];
  }
  // core/rotations.py quat_to_dcm_w2b (C), then M = R_wg C^T, then dcm_to_quat(M)
  const T qw = ln[6], qx = ln[7], qy = ln[8], qz = ln[9];
  const T C[3][3] = {
      {1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy + qw * qz), 2 * (qx * qz - qw * qy)},
      {2 * (qx * qy - qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz + qw * qx)},
      {2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx), 1 - 2 * (qx * qx + qy * qy)}};
  T M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = R[i][0] * C[j][0] + R[i][1] * C[j][1] + R[i][2] * C[j][2];
  const T tr = M[0][0] + M[1][1] + M[2][2];
  const T mags[4] = {k4_relu(1 + tr), k4_relu(1 + M[0][0] - M[1][1] - M[2][2]),
                     k4_relu(1 - M[0][0] + M[1][1] - M[2][2]), k4_relu(1 - M[0][0] - M[1][1] + M[2][2])};
  // Shepperd's candidates; the first maximum, as torch.argmax (a NaN is a
  // maximum), kept by value: a register array indexed at run time would go
  // to local memory
  int best = 0;
  T top = mags[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (!(mags[i] <= top) && !(top != top)) {
      best = i;
      top = mags[i];
    }
  const T d21 = M[2][1] - M[1][2], d02 = M[0][2] - M[2][0], d10 = M[1][0] - M[0][1];
  const T s01 = M[0][1] + M[1][0], s02 = M[0][2] + M[2][0], s12 = M[1][2] + M[2][1];
  T v[4];
  if (best == 0) { v[0] = top; v[1] = d21; v[2] = d02; v[3] = d10; }
  else if (best == 1) { v[0] = d21; v[1] = top; v[2] = s01; v[3] = s02; }
  else if (best == 2) { v[0] = d02; v[1] = s01; v[2] = top; v[3] = s12; }
  else { v[0] = d10; v[1] = s02; v[2] = s12; v[3] = top; }
  const T mag = top < T(1e-12) ? T(1e-12) : top;
  const T den = T(2) * sqrt(mag);
  const T sign = v[0] / den < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[6 + i] = sign * (v[i] / den);
  x[10] = ln[10];
  x[11] = ln[11];
  x[12] = ln[12];
  x[16] = k4_norm3(p[0][0] - p[1][0], p[0][1] - p[1][1], p[0][2] - p[1][2]);
  x[17] = k4_atan((p[0][2] - p[1][2]) / (p[0][0] - p[1][0]));
}

// DNN2's output 6 at the window inputs for time t, in every thread of the
// block (a collective call: every thread passes the same t).
template <typename T, bool REG>
struct Dnn2 {
  const T* ln;     // the lane's inputs (shared)
  const T* W1t;    // (18, 128) layer 1 transposed (shared)
  const T* W2t;    // (128, 128) layer 2 transposed (shared; f64)
  T* h1;           // (128,) layer 1's output (shared)
  T* red;          // (4,) the warps' partial sums (shared)
  T w2[REG ? K4_HID : 1];  // row j of layer 2 (registers; f32)
  T b1, b2, w3, b3;

  __device__ __forceinline__ T operator()(T t) {
    const int j = threadIdx.x;
    T x[K4_IN];
    k4_window(ln, t, x);
    T a = b1;
#pragma unroll
    for (int k = 0; k < K4_IN; ++k) a += W1t[k * K4_HID + j] * x[k];
    h1[j] = k4_relu(a);
    __syncthreads();
    T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int k = 0; k < K4_HID; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += (REG ? w2[REG ? k + u : 0] : W2t[(k + u) * K4_HID + j]) * h1[k + u];
    }
    T p = w3 * k4_relu(b2 + ((s[0] + s[1]) + (s[2] + s[3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_sync(0xffffffffu, p, (j & 31) ^ o);
    if ((j & 31) == 0) red[j >> 5] = p;
    __syncthreads();
    return b3 + ((red[0] + red[1]) + (red[2] + red[3]));
  }
};

template <typename T>
constexpr int k4_smem_bytes() {
  return (int)sizeof(T) * (K4_LANE + K4_HID + 4 + K4_IN * K4_HID + (sizeof(T) == 8 ? K4_HID * K4_HID : 0));
}

template <typename T, bool SECANT>
__global__ void __launch_bounds__(K4_HID, 1)
tsolve_kernel(const T* __restrict__ state, const T* __restrict__ fin, const T* __restrict__ pts,
              const T* __restrict__ velo, const T* __restrict__ wrate,
              const T* __restrict__ W1, const T* __restrict__ b1, const T* __restrict__ W2,
              const T* __restrict__ b2, const T* __restrict__ W3, const T* __restrict__ b3,
              const T tol, const int max_iters, const int B, T* __restrict__ t_out,
              int* __restrict__ count, int* __restrict__ fused, int* __restrict__ scratch) {
  constexpr bool REG = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char k4_smem[];
  T* ln = reinterpret_cast<T*>(k4_smem);  // [K4_LANE]
  T* h1 = ln + K4_LANE;                   // [K4_HID]
  T* red = h1 + K4_HID;                   // [4]
  T* W1t = red + 4;                       // [K4_IN][K4_HID]
  T* W2t = W1t + K4_IN * K4_HID;          // [K4_HID][K4_HID], f64 only
  const int j = threadIdx.x, b = blockIdx.x;

  if (j < 13) ln[j] = state[b * 13 + j];
  else if (j < 16) ln[j] = fin[b * 3 + j - L_FIN];
  else if (j < 28) ln[j] = pts[b * 12 + j - L_PTS];
  else if (j < 31) ln[j] = velo[b * 3 + j - L_VEL];
  else if (j == L_W) ln[j] = wrate[b];
  for (int k = 0; k < K4_IN; ++k) W1t[k * K4_HID + j] = W1[j * K4_IN + k];
  Dnn2<T, REG> f{ln, W1t, W2t, h1, red};
  if constexpr (REG) {
#pragma unroll
    for (int k = 0; k < K4_HID; ++k) f.w2[k] = W2[j * K4_HID + k];
  } else {
    for (int k = 0; k < K4_HID; ++k) W2t[k * K4_HID + j] = W2[j * K4_HID + k];
  }
  f.b1 = b1[j];
  f.b2 = b2[j];
  f.w3 = W3[6 * K4_HID + j];
  f.b3 = b3[6];
  __syncthreads();

  // the guess: |centroid - position| / 3
  T c[3];
  for (int k = 0; k < 3; ++k)
    c[k] = (((ln[L_PTS + k] + ln[L_PTS + 3 + k]) + ln[L_PTS + 6 + k]) + ln[L_PTS + 9 + k]) / T(4);
  const T t0 = k4_norm3(c[0] - ln[0], c[1] - ln[1], c[2] - ln[2]) / T(3);
  T t1;
  int it = 0;
  if constexpr (!SECANT) {
    // t1 <- t1 + (t2 - t1) / 2, t2 = DNN2 at t1, until |t2 - t1| <= tol
    t1 = t0;
    T t2 = f(t0);
    bool live = fabs(t2 - t0) > tol;
    while (live && it < max_iters) {
      t1 = t1 + (t2 - t1) / T(2);
      t2 = f(t1);
      live = fabs(t2 - t1) > tol;
      ++it;
    }
  } else {
    // guarded secant on g(t) = DNN2 at t - t, seeded by one averaging step;
    // the averaging step's g is evaluated only where the secant step is not taken
    T ta = t0, ga = f(t0) - t0;
    t1 = ta + ga / T(2);
    T g1 = f(t1) - t1;
    bool live = fabs(g1) > tol;
    while (live && it < max_iters) {
      const T denom = g1 - ga;
      const T sec = t1 - g1 * (t1 - ta) / denom;
      const bool ok = isfinite(sec) && fabs(denom) > T(1e-8);
      const T fall = k4_clamp(t1 + g1 / T(2), T(-20), T(20));
      const T cand = k4_clamp(ok ? sec : fall, T(-20), T(20));
      const T gc = f(cand) - cand;
      const bool use = fabs(gc) < fabs(g1);
      const T tn = use ? cand : fall;
      const T gn = use ? gc : f(fall) - fall;
      ta = t1;
      ga = g1;
      t1 = tn;
      g1 = gn;
      live = fabs(g1) > tol;
      ++it;
    }
  }
  if (j == 0) {
    t_out[b] = t1;
    if (fused != nullptr) {
      atomicAdd(&fused[1], it);
      if (b == 0) atomicAdd(&fused[0], 1);
    }
    if (count != nullptr) {  // the last block to finish adds the batch's maximum and zeroes the scratch
      atomicMax(&scratch[0], it);
      __threadfence();
      if (atomicAdd(&scratch[1], 1) == B - 1) {
        atomicAdd(&count[1], atomicExch(&scratch[0], 0));
        atomicExch(&scratch[1], 0);
      }
    }
  }
}

template <typename T>
int launch_tsolve(const T* state, const T* fin, const T* pts, const T* velo, const T* w, const T* W1,
                  const T* b1, const T* W2, const T* b2, const T* W3, const T* b3, double tol,
                  int max_iters, int secant, int B, T* t, int* count, int* fused, int* scratch,
                  cudaStream_t stream) {
  if (B == 0) return 0;
  constexpr int bytes = k4_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(tsolve_kernel<T, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tsolve_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (secant)
    tsolve_kernel<T, true><<<B, K4_HID, bytes, stream>>>(state, fin, pts, velo, w, W1, b1, W2, b2, W3, b3,
                                                        (T)tol, max_iters, B, t, count, fused, scratch);
  else
    tsolve_kernel<T, false><<<B, K4_HID, bytes, stream>>>(state, fin, pts, velo, w, W1, b1, W2, b2, W3, b3,
                                                         (T)tol, max_iters, B, t, count, fused, scratch);
  return (int)cudaGetLastError();
}

}  // namespace laf

extern "C" {

int laf_tsolve_f32(const float* state, const float* fin, const float* pts, const float* velo,
                   const float* w, const float* W1, const float* b1, const float* W2, const float* b2,
                   const float* W3, const float* b3, double tol, int max_iters, int secant, int B,
                   float* t, int* count, int* fused, int* scratch, cudaStream_t stream) {
  return laf::launch_tsolve<float>(state, fin, pts, velo, w, W1, b1, W2, b2, W3, b3, tol, max_iters,
                                   secant, B, t, count, fused, scratch, stream);
}

int laf_tsolve_f64(const double* state, const double* fin, const double* pts, const double* velo,
                   const double* w, const double* W1, const double* b1, const double* W2,
                   const double* b2, const double* W3, const double* b3, double tol, int max_iters,
                   int secant, int B, double* t, int* count, int* fused, int* scratch,
                   cudaStream_t stream) {
  return laf::launch_tsolve<double>(state, fin, pts, velo, w, W1, b1, W2, b2, W3, b3, tol, max_iters,
                                    secant, B, t, count, fused, scratch, stream);
}

// Bytes of K4's dynamic shared memory per block.
int laf_tsolve_smem_bytes(int f64) {
  return f64 ? laf::k4_smem_bytes<double>() : laf::k4_smem_bytes<float>();
}

}  // extern "C"
