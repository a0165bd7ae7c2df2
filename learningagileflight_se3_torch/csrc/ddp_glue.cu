// K6: the per-lane glue of a DDP iteration, around K2, K1 and K5.
//
// Replaces no TPU kernel: the JAX package's DDP iteration
// (learningagileflight_se3_tpu/solver/ilqr_batched.py) is one XLA program
// whose elementwise selects and tests XLA fuses; in PyTorch they are some
// 170 small kernels an iteration (solver/ilqr_batched.py
// BatchedSolver.iteration).  Three launches take their place:
//  - prepare (before K2): the sweep's input ZU = [Z[:-1]; U] and the
//    terminal quadratics phi_z, phi_zz of Z[H] (solver/analytic.py
//    make_final_quadratics);
//  - decide (after K2): the expected decrease, which lanes are active and
//    which deep, the (trial, lane) grid of step lengths K1 rolls out
//    (ops/line_search.py alpha_grid) and `go`, whether any lane is active;
//  - commit (after K5): the selects of Z, U, KK and J, the regularisation
//    schedule, the stall, progress-window and blow-out tests, the exit
//    status, the counters, every field gated by `go`.
// Their plain PyTorch versions (the CPU's path): ops/ddp_glue.py
// prepare_plain, decide_plain, commit_plain.
//
// Bound on the H100: bytes.  commit reads each value of Z, U and KK from
// the trajectory it keeps (the accepted trial's or the old one) and writes
// it once: 2 (H+1) 17 B + 2 H 4 B + 2 H 68 B values, 73 MB in f32 at H=50,
// B=2048, or 22 us at 3.35 TB/s; prepare copies Z and U into ZU and writes
// the quadratics (20 MB, 6 us); decide reads a few values a lane and writes
// the trials' step lengths (under 0.1 MB).  So:
//  - prepare is a grid of (lane, row chunk) blocks, a thread a lane, each
//    row a warp's 32 lanes in one contiguous segment, K6_BATCH rows' loads
//    in flight before their stores, K6_ROWS rows a block so that a B=128
//    launch still spreads over the card (a thread walking 64 rows one load
//    at a time took 33 us at B=2048 on an H100, five times its bytes' time);
//  - commit is a grid of the same blocks: a thread takes one lane,
//    recomputes that lane's decisions from its dozen inputs (a few dozen
//    flops), then copies its rows of Z, U and KK from the side it keeps, in
//    the same batches; the blocks of the first row chunk write the lane's
//    scalars;
//  - decide is one block that strides over the lanes, so that `go` is one
//    __syncthreads_or and needs no buffer cleared beforehand.  No kernel
//    has a lane limit.
// Every float operation is the one PyTorch's elementwise kernels perform,
// rounded as they round it: a Python number becomes the tensor's dtype
// first (tol * scale is __fmul_rn(float(tol), scale) in f32), and
// __fmul_rn, __fadd_rn, __fsub_rn and their f64 forms keep nvcc from
// contracting a multiply and an add into an FMA.  So every decision and
// every value is the plain version's, bit for bit.
//
// Layout: Z (H+1, 17, B), U (H, 4, B), KK (H, 4, 17, B), ZU (H, 21, B),
// phi_z (17, B), phi_zz (17, 17, B), the per-lane fields (B,), alpha
// (n_trials, B); bool as one byte; ls_n, ls_trips and max_iters int32 of
// one value; go one byte.
#include <cuda_runtime.h>

namespace laf {

// mirrors ops/ddp_glue.py GlueConsts
struct GlueConsts {
  double tol, gtol, stall_gtol;
  double reg_shrink, reg_min, reg_grow, reg_cap, reg_max;  // reg_cap: cfg.reg_max * 2.0
  double wrf2, wvf2, wwf2, wqf;                            // 2.0 * wrf etc., as Python forms them
  int n_alpha, stride, n_deep, n_trials;
  int escalate;           // ls_max_trips < line_search_steps: deep lanes exist
  int no_progress_iters;  // the progress window, 0 for none
  int ls_adaptive, use_wqf;
};

constexpr int K6_DECIDE_THREADS = 1024;  // decide's one block
constexpr int K6_LANES = 128;            // prepare's and commit's block: lanes
constexpr int K6_ROWS = 16;              // prepare's and commit's block: rows of their arrays
constexpr int K6_BATCH = 8;              // rows a thread has in flight: all loads, then all stores
constexpr int K6_NZ = 17, K6_NU = 4, K6_NZU = 21;

__device__ __forceinline__ float k6_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double k6_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float k6_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double k6_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float k6_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double k6_sub(double a, double b) { return __dsub_rn(a, b); }

// torch.clamp_min / clamp_max with a number: NaN stays NaN
template <typename T>
__device__ __forceinline__ T k6_clamp_min(T x, T lo) { return isnan(x) ? x : (x < lo ? lo : x); }
template <typename T>
__device__ __forceinline__ T k6_clamp_max(T x, T hi) { return isnan(x) ? x : (x > hi ? hi : x); }

// the lane's shared tests: decrement = -(dV1 + dV2), scale = |J| + 1
template <typename T>
struct LaneTests {
  T decrement, scale;
  bool active;
};

template <typename T>
__device__ __forceinline__ LaneTests<T> k6_tests(T J, T dV1, T dV2, bool done, int it, int max_iters) {
  LaneTests<T> t;
  t.decrement = -k6_add(dV1, dV2);
  t.scale = k6_add(fabs(J), T(1));
  t.active = !done && it < max_iters;
  return t;
}

// ------------------------------------------------------------------ prepare
// ZU's row (k, col): Z's row k * 17 + col, or U's row k * 4 + col - 17
template <typename T>
__device__ __forceinline__ const T* k6_zu_source(int row, const T* Z, const T* U, size_t sB) {
  const int k = row / K6_NZU, col = row % K6_NZU;
  return col < K6_NZ ? Z + ((size_t)k * K6_NZ + col) * sB : U + ((size_t)k * K6_NU + col - K6_NZ) * sB;
}

// lane b's entry of the quadratics' row `row`: phi_z's 17, then phi_zz's 17 x 17
template <typename T>
__device__ __forceinline__ T k6_quadratic(const GlueConsts& c, int H, int B, int b, int row, const T* __restrict__ Z,
                                          const T* __restrict__ goal) {
  const size_t sB = (size_t)B;
  const T* zH = Z + (size_t)H * K6_NZ * sB + b;
  if (row < K6_NZ) {
    const int i = row;
    const T z = zH[i * sB];
    if (i < 3) return k6_mul(T(c.wrf2), k6_sub(z, goal[i * sB + b]));
    if (i < 6) return k6_mul(T(c.wvf2), z);
    if (i >= 10 && i < 13) return k6_mul(T(c.wwf2), z);
    if (i >= 10 || !c.use_wqf) return T(0);
    // (zH[6:10] @ Hg)[i - 6], Hg = diag(0, 8, 8, 8) the identity's curvature:
    // each product is exact, so any order of the sum gives it
    T s = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) s = k6_add(s, k6_mul(zH[(6 + a) * sB], (a == i - 6 && a > 0) ? T(8) : T(0)));
    return k6_mul(T(c.wqf), s);
  }
  row -= K6_NZ;
  const int r = row / K6_NZ, q = row % K6_NZ;
  // the diagonal blocks 2 w I3 (off their diagonal 2 w * 0) and wqf Hg
  const T one = r == q ? T(1) : T(0);
  if (r < 3 && q < 3) return k6_mul(T(c.wrf2), one);
  if (r >= 3 && r < 6 && q >= 3 && q < 6) return k6_mul(T(c.wvf2), one);
  if (r >= 10 && r < 13 && q >= 10 && q < 13) return k6_mul(T(c.wwf2), one);
  if (c.use_wqf && r >= 6 && r < 10 && q >= 6 && q < 10) return k6_mul(T(c.wqf), r > 6 ? k6_mul(T(8), one) : T(0));
  return T(0);
}

template <typename T>
__global__ void __launch_bounds__(K6_LANES)
glue_prepare_kernel(const GlueConsts c, const int H, const int B, const T* __restrict__ Z,
                    const T* __restrict__ U, const T* __restrict__ goal, T* __restrict__ ZU,
                    T* __restrict__ phi_z, T* __restrict__ phi_zz) {
  const int b = blockIdx.x * K6_LANES + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int n_zu = H * K6_NZU, rows = n_zu + K6_NZ + K6_NZ * K6_NZ;
  const int r0 = blockIdx.y * K6_ROWS, r1 = r0 + K6_ROWS < rows ? r0 + K6_ROWS : rows;
  const int z1 = r1 < n_zu ? r1 : n_zu;
  for (int row = r0; row < z1; row += K6_BATCH) {
    T v[K6_BATCH];
#pragma unroll
    for (int u = 0; u < K6_BATCH; ++u)
      if (row + u < z1) v[u] = k6_zu_source(row + u, Z, U, sB)[b];
#pragma unroll
    for (int u = 0; u < K6_BATCH; ++u)
      if (row + u < z1) ZU[(size_t)(row + u) * sB + b] = v[u];
  }
  for (int row = r0 > n_zu ? r0 : n_zu; row < r1; ++row) {
    const int q = row - n_zu;
    (q < K6_NZ ? phi_z + (size_t)q * sB : phi_zz + (size_t)(q - K6_NZ) * sB)[b] = k6_quadratic(c, H, B, b, q, Z, goal);
  }
}

// ------------------------------------------------------------------- decide
template <typename T>
__global__ void __launch_bounds__(K6_DECIDE_THREADS)
glue_decide_kernel(const GlueConsts c, const int B, const T* __restrict__ J,
                   const T* __restrict__ dV1, const T* __restrict__ dV2,
                   const unsigned char* __restrict__ done, const int* __restrict__ it,
                   const int* __restrict__ max_iters, const int* __restrict__ n_np,
                   const int* __restrict__ ls0, unsigned char* __restrict__ deep_out,
                   unsigned char* __restrict__ skip_out, T* __restrict__ alpha,
                   unsigned char* __restrict__ go) {
  const int cap = *max_iters;
  const T tol = T(c.tol);
  int any = 0;
#pragma unroll 2
  for (int b = threadIdx.x; b < B; b += K6_DECIDE_THREADS) {
    const LaneTests<T> t = k6_tests(J[b], dV1[b], dV2[b], done[b] != 0, it[b], cap);
    // ladder escalation for live failure streaks; none under a full ladder
    const bool deep = c.escalate && n_np[b] >= 2 && t.decrement > k6_mul(tol, t.scale) && t.active;
    deep_out[b] = deep;
    skip_out[b] = !t.active;
    any |= t.active;
    // ops/line_search.py alpha_grid: trip j's step length 0.5 ** depth, by
    // the pow that PyTorch's kernel calls (in f64 not always 2 ** -depth)
    const int l0 = ls0[b];
    const int rungs = c.n_alpha - l0;
    const int L = deep ? c.n_deep : (rungs < 0 ? 0 : (rungs > c.stride ? c.stride : rungs));
    for (int j = 0; j < c.n_trials; ++j) {
      const int i = j < L ? j : L;
      int depth = deep ? i * c.stride : l0 + i;
      depth = depth < c.n_alpha - 1 ? depth : c.n_alpha - 1;
      alpha[(size_t)j * B + b] = pow(T(0.5), T(depth));
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *go = any != 0;
}

// ------------------------------------------------------------------- commit
// lane b's entry of rows [lo, hi) of src (rows, B) into dst, the range
// clipped to the array's rows, K6_BATCH rows in flight
template <typename T>
__device__ __forceinline__ void k6_copy_rows(const T* __restrict__ src, T* __restrict__ dst, int B, int b, int lo,
                                             int hi, int rows) {
  const int r1 = hi < rows ? hi : rows;
  for (int r = lo < 0 ? 0 : lo; r < r1; r += K6_BATCH) {
    T v[K6_BATCH];
#pragma unroll
    for (int u = 0; u < K6_BATCH; ++u)
      if (r + u < r1) v[u] = src[(size_t)(r + u) * B + b];
#pragma unroll
    for (int u = 0; u < K6_BATCH; ++u)
      if (r + u < r1) dst[(size_t)(r + u) * B + b] = v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(K6_LANES)
glue_commit_kernel(const GlueConsts c, const int H, const int B, const unsigned char* __restrict__ go_p,
                   // the state
                   const T* __restrict__ Z, const T* __restrict__ U, const T* __restrict__ J,
                   const T* __restrict__ KK, const T* __restrict__ reg,
                   const unsigned char* __restrict__ done, const int* __restrict__ it,
                   const T* __restrict__ pg_old, const int* __restrict__ ls_n,
                   const int* __restrict__ ls0, const int* __restrict__ n_np,
                   const T* __restrict__ J_chk, const int* __restrict__ w_it,
                   const int* __restrict__ st, const int* __restrict__ max_iters,
                   // K2's sweep
                   const T* __restrict__ KK_new, const T* __restrict__ dV1,
                   const T* __restrict__ dV2, const unsigned char* __restrict__ fail,
                   const T* __restrict__ pg,
                   // K5's search
                   const unsigned char* __restrict__ accepted, const T* __restrict__ Z_ls,
                   const T* __restrict__ U_ls, const T* __restrict__ J_ls,
                   const int* __restrict__ acc_idx, const int* __restrict__ ls_trips,
                   // the new state
                   T* __restrict__ Z_o, T* __restrict__ U_o, T* __restrict__ J_o,
                   T* __restrict__ KK_o, T* __restrict__ reg_o, unsigned char* __restrict__ done_o,
                   int* __restrict__ it_o, T* __restrict__ pg_o, int* __restrict__ ls_n_o,
                   int* __restrict__ ls0_o, int* __restrict__ n_np_o, T* __restrict__ J_chk_o,
                   int* __restrict__ w_it_o, int* __restrict__ st_o, int* __restrict__ count) {
  const bool go = *go_p != 0;
  const int b = blockIdx.x * K6_LANES + threadIdx.x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    *ls_n_o = go ? *ls_n + *ls_trips : *ls_n;
    if (count != nullptr && go) atomicAdd(count, 1);
  }
  if (b >= B) return;
  const T tol = T(c.tol);
  const T Jb = J[b], d1 = dV1[b], pgb = pg[b];
  const LaneTests<T> t = k6_tests(Jb, d1, dV2[b], done[b] != 0, it[b], *max_iters);
  // `sane` guards every |J|-relative tolerance
  const bool sane = isfinite(Jb) && fabs(Jb) < T(1e12);
  const bool failed = fail[b] != 0;
  const T tol_scale = k6_mul(tol, t.scale);
  const bool grad_small = pgb <= k6_mul(T(c.gtol), t.scale);
  const bool stationary = t.decrement <= tol_scale && d1 <= T(0) && grad_small && !failed && sane;
  const bool improved = accepted[b] != 0 && !failed && !stationary && t.active;
  // with go False nothing changes
  const bool take_ls = go && improved;
  const bool take_kk = go && (improved || (stationary && t.active));

  // this block's rows of Z, then U, then KK (rows stacked in that order),
  // each read from the side the lane keeps
  const int nz = (H + 1) * K6_NZ, nu = H * K6_NU, nk = H * K6_NU * K6_NZ;
  const int r0 = blockIdx.y * K6_ROWS, r1 = r0 + K6_ROWS;
  k6_copy_rows(take_ls ? Z_ls : Z, Z_o, B, b, r0, r1, nz);
  k6_copy_rows(take_ls ? U_ls : U, U_o, B, b, r0 - nz, r1 - nz, nu);
  k6_copy_rows(take_kk ? KK_new : KK, KK_o, B, b, r0 - nz - nu, r1 - nz - nu, nk);
  if (blockIdx.y != 0) return;

  const T J_n = improved ? J_ls[b] : Jb;
  const T rg = reg[b];
  const T reg_n = t.active ? (improved ? k6_clamp_min(k6_mul(rg, T(c.reg_shrink)), T(c.reg_min))
                                       : k6_clamp_max(k6_mul(rg, T(c.reg_grow)), T(c.reg_cap)))
                           : rg;
  const bool grad_smallish = pgb <= k6_mul(T(c.stall_gtol), t.scale);
  const bool stalled = !improved && !stationary && t.decrement <= tol_scale && rg >= T(64) &&
                       grad_smallish && sane;
  // progress window: terminate when a whole window of iterations made less
  // than tol cumulative progress
  const int np_n = t.active ? (improved ? 0 : n_np[b] + 1) : n_np[b];
  const int w_n = w_it[b] + (int)t.active;
  const bool window_full = c.no_progress_iters > 0 && w_n >= c.no_progress_iters;
  const T jc = J_chk[b];
  const bool window_progress = k6_sub(jc, J_n) > k6_mul(tol, k6_add(fabs(J_n), T(1)));
  const bool floor_exit = window_full && !window_progress && sane;
  const bool blowout = !improved && !stationary && rg > T(c.reg_max);
  const bool done_n = done[b] != 0 || (t.active && (stationary || stalled || floor_exit || blowout));
  // exit taxonomy; each reason implies done
  int s = st[b];
  if (t.active) {
    if (stationary)
      s = 1;
    else if (stalled)
      s = 2;
    else if (floor_exit)
      s = 3;
    else if (blowout)
      s = 4;
  }
  int l0 = ls0[b];
  if (c.ls_adaptive && improved && t.active) l0 = acc_idx[b] - 1 > 0 ? acc_idx[b] - 1 : 0;

  J_o[b] = go ? J_n : Jb;
  reg_o[b] = go ? reg_n : rg;
  done_o[b] = go ? done_n : done[b] != 0;
  it_o[b] = go ? it[b] + (int)t.active : it[b];
  pg_o[b] = go ? pgb : pg_old[b];
  ls0_o[b] = go ? l0 : ls0[b];
  n_np_o[b] = go ? np_n : n_np[b];
  J_chk_o[b] = go && window_full && t.active ? J_n : jc;
  w_it_o[b] = go ? (window_full && t.active ? 0 : w_n) : w_it[b];
  st_o[b] = go ? s : st[b];
  if (count != nullptr && go && t.active) atomicAdd(count + 1, 1);
}

// ------------------------------------------------------------------ launches

// (lane chunks, row chunks) of an array of `rows` rows
inline dim3 k6_grid(int B, int rows) {
  return dim3((B + K6_LANES - 1) / K6_LANES > 0 ? (B + K6_LANES - 1) / K6_LANES : 1, (rows + K6_ROWS - 1) / K6_ROWS);
}

template <typename T>
int launch_glue_prepare(const GlueConsts* c, int H, int B, const T* Z, const T* U, const T* goal, T* ZU,
                        T* phi_z, T* phi_zz, cudaStream_t stream) {
  if (B == 0) return 0;
  const dim3 grid = k6_grid(B, H * K6_NZU + K6_NZ + K6_NZ * K6_NZ);
  glue_prepare_kernel<T><<<grid, K6_LANES, 0, stream>>>(*c, H, B, Z, U, goal, ZU, phi_z, phi_zz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_glue_decide(const GlueConsts* c, int B, const T* J, const T* dV1, const T* dV2,
                       const unsigned char* done, const int* it, const int* max_iters, const int* n_np,
                       const int* ls0, unsigned char* deep, unsigned char* skip, T* alpha,
                       unsigned char* go, cudaStream_t stream) {
  glue_decide_kernel<T><<<1, K6_DECIDE_THREADS, 0, stream>>>(*c, B, J, dV1, dV2, done, it, max_iters,
                                                             n_np, ls0, deep, skip, alpha, go);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_glue_commit(const GlueConsts* c, int H, int B, const unsigned char* go, const T* Z, const T* U,
                       const T* J, const T* KK, const T* reg, const unsigned char* done, const int* it,
                       const T* pg_old, const int* ls_n, const int* ls0, const int* n_np, const T* J_chk,
                       const int* w_it, const int* st, const int* max_iters, const T* KK_new, const T* dV1,
                       const T* dV2, const unsigned char* fail, const T* pg, const unsigned char* accepted,
                       const T* Z_ls, const T* U_ls, const T* J_ls, const int* acc_idx, const int* ls_trips,
                       T* Z_o, T* U_o, T* J_o, T* KK_o, T* reg_o, unsigned char* done_o, int* it_o, T* pg_o,
                       int* ls_n_o, int* ls0_o, int* n_np_o, T* J_chk_o, int* w_it_o, int* st_o, int* count,
                       cudaStream_t stream) {
  const dim3 grid = k6_grid(B, (H + 1) * K6_NZ + H * K6_NU + H * K6_NU * K6_NZ);
  glue_commit_kernel<T><<<grid, K6_LANES, 0, stream>>>(
      *c, H, B, go, Z, U, J, KK, reg, done, it, pg_old, ls_n, ls0, n_np, J_chk, w_it, st, max_iters, KK_new,
      dV1, dV2, fail, pg, accepted, Z_ls, U_ls, J_ls, acc_idx, ls_trips, Z_o, U_o, J_o, KK_o, reg_o, done_o,
      it_o, pg_o, ls_n_o, ls0_o, n_np_o, J_chk_o, w_it_o, st_o, count);
  return (int)cudaGetLastError();
}

}  // namespace laf

#define LAF_GLUE_ENTRY_POINTS(T, SUFFIX)                                                                  \
  int laf_glue_prepare_##SUFFIX(const laf::GlueConsts* c, int H, int B, const T* Z, const T* U,          \
                                const T* goal, T* ZU, T* phi_z, T* phi_zz, cudaStream_t stream) {       \
    return laf::launch_glue_prepare<T>(c, H, B, Z, U, goal, ZU, phi_z, phi_zz, stream);                  \
  }                                                                                                      \
  int laf_glue_decide_##SUFFIX(const laf::GlueConsts* c, int B, const T* J, const T* dV1, const T* dV2,  \
                               const unsigned char* done, const int* it, const int* max_iters,           \
                               const int* n_np, const int* ls0, unsigned char* deep,                     \
                               unsigned char* skip, T* alpha, unsigned char* go, cudaStream_t stream) {  \
    return laf::launch_glue_decide<T>(c, B, J, dV1, dV2, done, it, max_iters, n_np, ls0, deep, skip,     \
                                      alpha, go, stream);                                                \
  }                                                                                                      \
  int laf_glue_commit_##SUFFIX(                                                                          \
      const laf::GlueConsts* c, int H, int B, const unsigned char* go, const T* Z, const T* U,           \
      const T* J, const T* KK, const T* reg, const unsigned char* done, const int* it, const T* pg_old,  \
      const int* ls_n, const int* ls0, const int* n_np, const T* J_chk, const int* w_it, const int* st,  \
      const int* max_iters, const T* KK_new, const T* dV1, const T* dV2, const unsigned char* fail,      \
      const T* pg, const unsigned char* accepted, const T* Z_ls, const T* U_ls, const T* J_ls,           \
      const int* acc_idx, const int* ls_trips, T* Z_o, T* U_o, T* J_o, T* KK_o, T* reg_o,                \
      unsigned char* done_o, int* it_o, T* pg_o, int* ls_n_o, int* ls0_o, int* n_np_o, T* J_chk_o,       \
      int* w_it_o, int* st_o, int* count, cudaStream_t stream) {                                         \
    return laf::launch_glue_commit<T>(c, H, B, go, Z, U, J, KK, reg, done, it, pg_old, ls_n, ls0, n_np,  \
                                      J_chk, w_it, st, max_iters, KK_new, dV1, dV2, fail, pg, accepted,  \
                                      Z_ls, U_ls, J_ls, acc_idx, ls_trips, Z_o, U_o, J_o, KK_o, reg_o,   \
                                      done_o, it_o, pg_o, ls_n_o, ls0_o, n_np_o, J_chk_o, w_it_o, st_o,  \
                                      count, stream);                                                    \
  }

extern "C" {
LAF_GLUE_ENTRY_POINTS(float, f32)
LAF_GLUE_ENTRY_POINTS(double, f64)
}  // extern "C"
