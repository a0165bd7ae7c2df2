// K5: the line search's first-accept rule over a grid of trial rollouts.
//
// Replaces no TPU kernel: the JAX package's line search
// (learningagileflight_se3_tpu/solver/ilqr_batched.py) is a loop of K1
// launches whose selects XLA fuses; in PyTorch that loop is some 40 small
// kernels a trip around each K1 launch.  The solver
// (solver/ilqr_batched.py BatchedSolver.line_search) rolls every trial out
// at once instead, in one K1 launch over a (trial, lane) grid, and K5 then
// replays the loop's recurrence over the trial axis, reading each trip's
// costs from the grid: which lanes are live, whether any is (the trip's
// gate), the acceptance test, the trip counts; then it gathers each lane's
// accepted trial, or keeps its trajectory.  Its plain PyTorch version (the
// CPU's path): ops/line_search.py first_accept_plain.
//
// Bound on the H100.  The gather moves (H+1) 17 B + H 4 B values and writes
// as many (1.1 MB in f32 at H=50, B=128: well under 1 us at 3.35 TB/s); the
// recurrence is a few dozen flops a trial and lane, but one step per trip
// waits on a block-wide OR.  So:
//  - every block replays the whole recurrence (a few dozen flops a trial
//    and lane: microseconds at the solver's batches), lanes strided over its
//    threads, __syncthreads_or for each trip's gate, each lane's state in
//    shared memory (9 bytes a lane: laf_line_search_max_lanes is the most a
//    block holds, 25,827 on an H100); no block waits for another;
//  - then each block gathers its own contiguous share of Zb and Ub, so the
//    copy spreads over the card; block 0 writes the per-lane results.  At
//    most K5_MAX_BLOCKS blocks, so that the replays' work stays linear in
//    the lanes.
// The acceptance test rounds each operation as PyTorch's elementwise kernels
// do (ops/build.py builds f32 division in its fast form, and nvcc would
// contract a multiply and an add into an FMA): __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and their f64 forms, in the solver's order, so every
// decision is the ladder's.
//
// Layout: Z (H+1, 17, B), U (H, 4, B), J, dV1, dV2 (B,), Zn (T, H, 17, B)
// states 1..H of each trial, Un (T, H, 4, B), Jn and alpha (T, B), ls0
// (int32, B), deep and skip (bool, B) -> Zb (H+1, 17, B), Ub (H, 4, B), Jb
// (B,), accepted (bool, B), acc_idx (int32, B), ls_trips (int32, one: the
// trips the ladder would run).  count (int32 [2], or null) gets [1, the
// trips] where the search runs any trip.
#include <cuda_runtime.h>

namespace laf {

constexpr int K5_THREADS = 256;
constexpr int K5_PER_THREAD = 16;  // values a thread gathers, which sets the blocks
constexpr int K5_MAX_BLOCKS = 512;
constexpr int K5_NZ = 17, K5_NU = 4;

__device__ __forceinline__ float k5_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double k5_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float k5_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double k5_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float k5_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double k5_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float k5_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double k5_div(double a, double b) { return __ddiv_rn(a, b); }

// the floor of the expected decrease (the solver's `tiny`)
template <typename T>
__device__ __forceinline__ T k5_tiny();
template <>
__device__ __forceinline__ float k5_tiny<float>() { return 1e-30f; }
template <>
__device__ __forceinline__ double k5_tiny<double>() { return 1e-300; }

// is a lane live in the search: not accepted, its depth on the ladder and
// its trips under their limits (a deep lane: stride steps a trip, n_deep trips)
__device__ __forceinline__ bool k5_live(bool acc, int i, int ls0, bool deep, int n_alpha,
                                        int stride, int n_deep) {
  const int depth = deep ? i * stride : ls0 + i;
  return !acc && depth < n_alpha && i < (deep ? n_deep : stride);
}

inline int k5_smem_bytes(int B) { return B * (2 * (int)sizeof(int) + 1); }

template <typename T>
__global__ void __launch_bounds__(K5_THREADS)
line_search_kernel(const int n_trials, const int H, const int B, const int n_alpha,
                   const int stride, const int n_deep,
                   const T* __restrict__ Z, const T* __restrict__ U, const T* __restrict__ J,
                   const T* __restrict__ Zn, const T* __restrict__ Un, const T* __restrict__ Jn,
                   const T* __restrict__ alpha, const T* __restrict__ dV1,
                   const T* __restrict__ dV2, const int* __restrict__ ls0,
                   const unsigned char* __restrict__ deep, const unsigned char* __restrict__ skip,
                   T* __restrict__ Zb, T* __restrict__ Ub, T* __restrict__ Jb,
                   unsigned char* __restrict__ accepted, int* __restrict__ acc_idx,
                   int* __restrict__ ls_trips, int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char k5_smem[];
  int* sel = reinterpret_cast<int*>(k5_smem);  // [B] the accepted trial, -1 for none
  int* it = sel + B;                            // [B] the lane's trips (the solver's i)
  unsigned char* acc = reinterpret_cast<unsigned char*>(it + B);  // [B]
  const int tid = threadIdx.x;
  const T tiny = k5_tiny<T>();

  // a lane is touched by one thread only until the gather
  for (int b = tid; b < B; b += K5_THREADS) {
    sel[b] = -1;
    it[b] = 0;
    acc[b] = skip[b];
  }
  int trips = 0;
#pragma unroll 1
  for (int j = 0; j < n_trials; ++j) {
    int any = 0;
    for (int b = tid; b < B; b += K5_THREADS)
      any |= k5_live(acc[b], it[b], ls0[b], deep[b], n_alpha, stride, n_deep);
    if (!__syncthreads_or(any)) break;  // the trip's gate: no lane live, no later trip either
    ++trips;
    for (int b = tid; b < B; b += K5_THREADS) {
      const bool live = k5_live(acc[b], it[b], ls0[b], deep[b], n_alpha, stride, n_deep);
      if (!acc[b]) {
        // not masked by `live`: a lane out of trips still accepts while
        // another lane keeps the search going
        const T a = alpha[(size_t)j * B + b], jn = Jn[(size_t)j * B + b], j0 = J[b];
        const T expected = -k5_add(k5_mul(a, dV1[b]), k5_mul(k5_mul(a, a), dV2[b]));
        const T floor = isnan(expected) ? expected : (expected > tiny ? expected : tiny);
        if (jn < j0 && expected > T(0) && k5_div(k5_sub(j0, jn), floor) > T(0.1)) {
          acc[b] = 1;
          sel[b] = j;
        }
      }
      it[b] += live;
    }
  }
  __syncthreads();

  if (blockIdx.x == 0) {
    for (int b = tid; b < B; b += K5_THREADS) {
      const int i = it[b];
      accepted[b] = acc[b];
      const int idx = deep[b] ? (i - 1) * stride : ls0[b] + i - 1;
      acc_idx[b] = acc[b] ? min(idx, n_alpha - 1) : ls0[b];
      Jb[b] = sel[b] >= 0 ? Jn[(size_t)sel[b] * B + b] : J[b];
    }
    // the deepest lane's trips are the trips run: a lane live at a trip was
    // live at every trip before it
    if (tid == 0) {
      *ls_trips = trips;
      if (count != nullptr && trips > 0) {
        atomicAdd(count, 1);
        atomicAdd(count + 1, trips);
      }
    }
  }

  // this block's share of Zb then Ub, flattened
  const size_t nz = (size_t)(H + 1) * K5_NZ * B, n = nz + (size_t)H * K5_NU * B;
  const size_t share = (n + gridDim.x - 1) / gridDim.x;
  const size_t e0 = (size_t)blockIdx.x * share;
  const size_t e1 = e0 + share < n ? e0 + share : n;
  for (size_t e = e0 + tid; e < e1; e += K5_THREADS) {
    if (e < nz) {
      const int s = sel[e % B];
      // state 0 is the rollouts' start; state k >= 1 is row k - 1 of the trial's
      Zb[e] = (e < (size_t)K5_NZ * B || s < 0) ? Z[e] : Zn[(size_t)s * H * K5_NZ * B + e - (size_t)K5_NZ * B];
    } else {
      const size_t f = e - nz;
      const int s = sel[f % B];
      Ub[f] = s < 0 ? U[f] : Un[(size_t)s * H * K5_NU * B + f];
    }
  }
}

template <typename T>
int launch_line_search(int n_trials, int H, int B, int n_alpha, int stride, int n_deep,
                       const T* Z, const T* U, const T* J, const T* Zn, const T* Un, const T* Jn,
                       const T* alpha, const T* dV1, const T* dV2, const int* ls0,
                       const unsigned char* deep, const unsigned char* skip, T* Zb, T* Ub, T* Jb,
                       unsigned char* accepted, int* acc_idx, int* ls_trips, int* count,
                       cudaStream_t stream) {
  if (B == 0) return 0;
  const int bytes = k5_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(line_search_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)((H + 1) * K5_NZ + H * K5_NU) * B;
  const long long per_block = (long long)K5_THREADS * K5_PER_THREAD;
  const long long blocks = (n + per_block - 1) / per_block;
  const int grid = blocks < K5_MAX_BLOCKS ? (int)blocks : K5_MAX_BLOCKS;
  line_search_kernel<T><<<grid, K5_THREADS, bytes, stream>>>(
      n_trials, H, B, n_alpha, stride, n_deep, Z, U, J, Zn, Un, Jn, alpha, dV1, dV2, ls0, deep,
      skip, Zb, Ub, Jb, accepted, acc_idx, ls_trips, count);
  return (int)cudaGetLastError();
}

}  // namespace laf

extern "C" {

int laf_line_search_f32(int n_trials, int H, int B, int n_alpha, int stride, int n_deep,
                        const float* Z, const float* U, const float* J, const float* Zn,
                        const float* Un, const float* Jn, const float* alpha, const float* dV1,
                        const float* dV2, const int* ls0, const unsigned char* deep,
                        const unsigned char* skip, float* Zb, float* Ub, float* Jb,
                        unsigned char* accepted, int* acc_idx, int* ls_trips, int* count,
                        cudaStream_t stream) {
  return laf::launch_line_search<float>(n_trials, H, B, n_alpha, stride, n_deep, Z, U, J, Zn, Un,
                                        Jn, alpha, dV1, dV2, ls0, deep, skip, Zb, Ub, Jb, accepted,
                                        acc_idx, ls_trips, count, stream);
}

int laf_line_search_f64(int n_trials, int H, int B, int n_alpha, int stride, int n_deep,
                        const double* Z, const double* U, const double* J, const double* Zn,
                        const double* Un, const double* Jn, const double* alpha, const double* dV1,
                        const double* dV2, const int* ls0, const unsigned char* deep,
                        const unsigned char* skip, double* Zb, double* Ub, double* Jb,
                        unsigned char* accepted, int* acc_idx, int* ls_trips, int* count,
                        cudaStream_t stream) {
  return laf::launch_line_search<double>(n_trials, H, B, n_alpha, stride, n_deep, Z, U, J, Zn, Un,
                                         Jn, alpha, dV1, dV2, ls0, deep, skip, Zb, Ub, Jb,
                                         accepted, acc_idx, ls_trips, count, stream);
}

// the most lanes K5 takes on `device`: their state in one block's shared
// memory (0 where the query fails)
int laf_line_search_max_lanes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return bytes / laf::k5_smem_bytes(1);
}

}  // extern "C"
