// Shared device code of the kernels (rollout.cu, riccati_fused.cu,
// riccati_unfused.cu).
//
// The launch-constant struct, NaN-propagating max/min/clip, the attitude
// error, the per-scenario 4x4 Cholesky and projected-Newton boxQP, and the
// sparse DDP second-order term: the lane helpers of
// learningagileflight_se3_tpu/ops/riccati_pallas.py (_chol4, _chol4_solve,
// _masked4, _boxqp_lanes, _h2_lanes) written for one thread.  Their plain
// PyTorch versions are solver/chol4.py, solver/boxqp.py and
// solver/analytic.py explicit_h2.  Besides: the asynchronous copies
// (cp.async) and the register-array select that the cooperative kernels
// (K1, K2, K3) use.
//
// NaN semantics follow jnp.maximum / jnp.clip, which propagate a NaN;
// CUDA's fmaxf / fminf drop it, so they are not used anywhere here.
#pragma once

#include <cuda_runtime.h>

namespace laf {

constexpr int NX = 13;
constexpr int NU = 4;
constexpr int NZ = NX + NU;
constexpr int NZU = NZ + NU;

// v[i] of a register array for a runtime i, as a chain of selects: indexing
// the array itself by a runtime value would move it to local memory.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T r = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = i == j ? v[j] : r;
  return r;
}

// M[i][c] for a runtime row i and a compile-time column c.
template <typename T, int R, int C>
__device__ __forceinline__ T pick(const T (&M)[R][C], int i, int c) {
  T r = M[0][c];
#pragma unroll
  for (int j = 1; j < R; ++j) r = i == j ? M[j][c] : r;
  return r;
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory; the
// 16-byte form bypasses L1.  Completion: cp_async_commit() closes a group,
// cp_async_wait<N>() waits until at most N of this thread's groups are
// pending; other threads see the data after a barrier.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Mirrored by ops/build.py KernelConsts: 20 doubles, then 4 ints.
struct Consts {
  double Jx, Jy, Jz, mass, l, c, g;
  double wrt, wqt, wthrust, wrf, wvf, wqf, wwf, w_du;
  double dt, lb, ub, w_bound, w_bound_weight;
  int squared_attitude, use_wqf, use_ddp, boxqp_iters;
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nclip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}

// jnp.sign: 0 at 0, NaN at NaN (copysign would give +-1 at 0)
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// All 9 entries of C_B_I(q), row-major.
template <typename T>
__device__ __forceinline__ void dcm_rows(T w, T x, T y, T z, T r[9]) {
  r[0] = 1 - 2 * (y * y + z * z); r[1] = 2 * (x * y + w * z); r[2] = 2 * (x * z - w * y);
  r[3] = 2 * (x * y - w * z); r[4] = 1 - 2 * (x * x + z * z); r[5] = 2 * (y * z + w * x);
  r[6] = 2 * (x * z + w * y); r[7] = 2 * (y * z - w * x); r[8] = 1 - 2 * (x * x + y * y);
}

// 3 - <C(qg), C(q)>_F  (costs/gate_costs.attitude_error)
template <typename T>
__device__ __forceinline__ T attitude_error(const T q[4], const T qg[4]) {
  T a[9], b[9];
  dcm_rows(q[0], q[1], q[2], q[3], a);
  dcm_rows(qg[0], qg[1], qg[2], qg[3], b);
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) acc += a[i] * b[i];
  return T(3) - acc;
}

template <typename T>
struct Chol4 {
  T l00, l10, l20, l30, l11, l21, l31, l22, l32, l33;
  T r00, r11, r22, r33;  // 1 / l_ii
  bool ok;
};

// Unrolled 4x4 Cholesky with the pivot test of _chol4 (tol 1e-12 in f64,
// 1e-7 in f32, relative to max(|diag|, 1)); pivots floored at 1e-30.  The
// reciprocal pivots are computed beside the factor, off its dependent chain.
template <typename T>
__device__ __forceinline__ Chol4<T> chol4(const T M[4][4]) {
  const T eps = T(1e-30);
  const T tol = sizeof(T) == 8 ? T(1e-12) : T(1e-7);
  Chol4<T> L;
  T d0 = M[0][0];
  L.l00 = sqrt(nmax(d0, eps));
  L.r00 = T(1) / L.l00;
  L.l10 = M[1][0] / L.l00;
  L.l20 = M[2][0] / L.l00;
  L.l30 = M[3][0] / L.l00;
  T d1 = M[1][1] - L.l10 * L.l10;
  L.l11 = sqrt(nmax(d1, eps));
  L.r11 = T(1) / L.l11;
  L.l21 = (M[2][1] - L.l20 * L.l10) / L.l11;
  L.l31 = (M[3][1] - L.l30 * L.l10) / L.l11;
  T d2 = M[2][2] - L.l20 * L.l20 - L.l21 * L.l21;
  L.l22 = sqrt(nmax(d2, eps));
  L.r22 = T(1) / L.l22;
  L.l32 = (M[3][2] - L.l30 * L.l20 - L.l31 * L.l21) / L.l22;
  T d3 = M[3][3] - L.l30 * L.l30 - L.l31 * L.l31 - L.l32 * L.l32;
  L.l33 = sqrt(nmax(d3, eps));
  L.r33 = T(1) / L.l33;
  T scale = nmax(nmax(nmax(fabs(M[0][0]), fabs(M[1][1])), nmax(fabs(M[2][2]), fabs(M[3][3]))), T(1));
  T ts = tol * scale;
  L.ok = (d0 > ts) && (d1 > ts) && (d2 > ts) && (d3 > ts);
  return L;
}

// Solve (L L^T) x = b, multiplying by the reciprocal pivots: eight dependent
// divisions would be the longest chain of a step (within an ulp or two of
// dividing).
template <typename T>
__device__ __forceinline__ void chol4_solve(const Chol4<T>& L, const T b[4], T x[4]) {
  T y0 = b[0] * L.r00;
  T y1 = (b[1] - L.l10 * y0) * L.r11;
  T y2 = (b[2] - L.l20 * y0 - L.l21 * y1) * L.r22;
  T y3 = (b[3] - L.l30 * y0 - L.l31 * y1 - L.l32 * y2) * L.r33;
  x[3] = y3 * L.r33;
  x[2] = (y2 - L.l32 * x[3]) * L.r22;
  x[1] = (y1 - L.l21 * x[2] - L.l31 * x[3]) * L.r11;
  x[0] = (y0 - L.l10 * x[1] - L.l20 * x[2] - L.l30 * x[3]) * L.r00;
}

// F H F + (I - F): exact on the free block, identity on the clamped.
template <typename T>
__device__ __forceinline__ void masked4(const T H[4][4], const T fr[4], T M[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      M[i][j] = H[i][j] * (fr[i] * fr[j]) + (i == j ? T(1) - fr[i] : T(0));
    }
  }
}

template <typename T>
__device__ __forceinline__ void mat_vec4(const T H[4][4], const T x[4], T y[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = H[i][0] * x[0] + H[i][1] * x[1] + H[i][2] * x[2] + H[i][3] * x[3];
}

template <typename T>
__device__ __forceinline__ T qobj4(const T H[4][4], const T g[4], const T x[4]) {
  T Hx[4];
  mat_vec4(H, x, Hx);
  return T(0.5) * (x[0] * Hx[0] + x[1] * Hx[1] + x[2] * Hx[2] + x[3] * Hx[3]) +
         (g[0] * x[0] + g[1] * x[1] + g[2] * x[2] + g[3] * x[3]);
}

template <typename T>
__device__ __forceinline__ void free_mask4(const T d[4], const T grad[4], const T lo[4],
                                           const T hi[4], T fr[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool at_lo = (d[i] <= lo[i] + T(1e-12)) && (grad[i] > T(0));
    bool at_hi = (d[i] >= hi[i] - T(1e-12)) && (grad[i] < T(0));
    fr[i] = (at_lo || at_hi) ? T(0) : T(1);
  }
}

// Projected-Newton boxQP  min 0.5 d'Hd + g'd  s.t. lo <= d <= hi
// (_boxqp_lanes): returns d and the free mask of the final iterate.  An
// iteration is a function of d alone, so once one leaves d where it was,
// every later one would too: the loop stops there with the result of all
// `iters` (on the solver's trajectories after 3 of the 6 on average).
template <typename T>
__device__ void boxqp(const T H[4][4], const T g[4], const T lo[4], const T hi[4], int iters,
                      T d[4], T fr[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = nclip(T(0), lo[i], hi[i]);
  T grad[4], Hd[4], M[4][4], rhs[4], step[4], best[4], cand[4];
  T cur = qobj4(H, g, d);  // the objective at d, carried over from the selection
  for (int it = 0; it < iters; ++it) {
    mat_vec4(H, d, Hd);
#pragma unroll
    for (int i = 0; i < 4; ++i) grad[i] = g[i] + Hd[i];
    free_mask4(d, grad, lo, hi, fr);
    masked4(H, fr, M);
    Chol4<T> L = chol4(M);
#pragma unroll
    for (int i = 0; i < 4; ++i) rhs[i] = -(grad[i] * fr[i]);
    chol4_solve(L, rhs, step);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      step[i] *= fr[i];
      best[i] = d[i];
    }
    // NaN-robust sequential selection: an overflowed candidate loses
    T best_val = cur;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const T scale = s == 0 ? T(1) : (s == 1 ? T(0.5) : T(0.25));
#pragma unroll
      for (int i = 0; i < 4; ++i) cand[i] = nclip(d[i] + scale * step[i], lo[i], hi[i]);
      T val = qobj4(H, g, cand);
      if (val < best_val) {
#pragma unroll
        for (int i = 0; i < 4; ++i) best[i] = cand[i];
        best_val = val;
      }
    }
    bool moved = false;  // a NaN iterate counts as moved
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      moved = moved || best[i] != d[i];
      d[i] = best[i];
    }
    cur = best_val;
    if (!moved) break;
  }
  mat_vec4(H, d, Hd);
#pragma unroll
  for (int i = 0; i < 4; ++i) grad[i] = g[i] + Hd[i];
  free_mask4(d, grad, lo, hi, fr);
}

// DDP second-order term: the nonzero blocks of hess_zu(Vz . f)(zu)
// (_h2_lanes, solver/analytic.py explicit_h2) at the pre-update Vz, scaled
// by dt and added to Qzz and Quz (its Quu block is zero).  q = zu[6..9],
// usum = u0 + u1 + u2 + u3.
template <typename T>
__device__ __forceinline__ void add_ddp_term(const Consts& cs, const T q[4], const T usum,
                                             const T Vz[NZ], T Qzz[NZ][NZ], T Quz[NU][NZ]) {
  const T dt = T(cs.dt), m = T(cs.mass);
  const T Jx = T(cs.Jx), Jy = T(cs.Jy), Jz = T(cs.Jz);
  const T w0 = q[0], x0 = q[1], y0 = q[2], z0 = q[3];
  const T a_ = Vz[3], b_ = Vz[4], c_ = Vz[5];
  const T Tm = usum / m;
  const T Hqq[4][4] = {{T(0), -2 * b_, 2 * a_, T(0)},
                       {-2 * b_, -4 * c_, T(0), 2 * a_},
                       {2 * a_, T(0), -4 * c_, 2 * b_},
                       {T(0), 2 * a_, 2 * b_, T(0)}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) Qzz[6 + i][6 + j] += dt * (Hqq[i][j] * Tm);
  const T hqu[4] = {(2 * y0 * Vz[3] - 2 * x0 * Vz[4]) / m,
                    (2 * z0 * Vz[3] - 2 * w0 * Vz[4] - 4 * x0 * Vz[5]) / m,
                    (2 * w0 * Vz[3] + 2 * z0 * Vz[4] - 4 * y0 * Vz[5]) / m,
                    (2 * x0 * Vz[3] + 2 * y0 * Vz[4]) / m};
  const T* lq = Vz + 6;
  const T P[4][3] = {{lq[1] * T(0.5), lq[2] * T(0.5), lq[3] * T(0.5)},
                     {-lq[0] * T(0.5), lq[3] * T(0.5), -lq[2] * T(0.5)},
                     {-lq[3] * T(0.5), -lq[0] * T(0.5), lq[1] * T(0.5)},
                     {lq[2] * T(0.5), -lq[1] * T(0.5), -lq[0] * T(0.5)}};
  for (int i = 0; i < 4; ++i)
    for (int cc = 0; cc < 3; ++cc) {
      Qzz[6 + i][10 + cc] += dt * P[i][cc];
      Qzz[10 + cc][6 + i] += dt * P[i][cc];
    }
  const T d1 = T(cs.Jz - cs.Jy) * (Vz[10] / Jx);
  const T d2 = T(cs.Jx - cs.Jz) * (Vz[11] / Jy);
  const T d3 = T(cs.Jy - cs.Jx) * (Vz[12] / Jz);
  const T Sww[3][3] = {{T(0), d3, d2}, {d3, T(0), d1}, {d2, d1, T(0)}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Qzz[10 + i][10 + j] += -dt * Sww[i][j];
  for (int j = 0; j < NU; ++j)
    for (int i = 0; i < 4; ++i) Quz[j][6 + i] += dt * hqu[i];
}

// add_ddp_term for one column cc of Qzz and of Quz (qzz[NZ], quz[NU] in
// registers), as K2's lane cc holds them: every entry gets the same addend,
// computed by the same expression, as in add_ddp_term.
template <typename T>
__device__ __forceinline__ void add_ddp_term_col(const Consts& cs, const T q[4], const T usum,
                                                 const T* Vz, const int cc, T qzz[NZ],
                                                 T quz[NU]) {
  if (cc < 6 || cc >= NX) return;
  const T dt = T(cs.dt), m = T(cs.mass);
  const T Jx = T(cs.Jx), Jy = T(cs.Jy), Jz = T(cs.Jz);
  const T a_ = Vz[3], b_ = Vz[4], c_ = Vz[5];
  const T* lq = Vz + 6;
  const T P[4][3] = {{lq[1] * T(0.5), lq[2] * T(0.5), lq[3] * T(0.5)},
                     {-lq[0] * T(0.5), lq[3] * T(0.5), -lq[2] * T(0.5)},
                     {-lq[3] * T(0.5), -lq[0] * T(0.5), lq[1] * T(0.5)},
                     {lq[2] * T(0.5), -lq[1] * T(0.5), -lq[0] * T(0.5)}};
  if (cc < 10) {  // quaternion column j: Hqq, P^T, hqu
    const int j = cc - 6;
    const T w0 = q[0], x0 = q[1], y0 = q[2], z0 = q[3];
    const T Tm = usum / m;
    const T Hqq[4][4] = {{T(0), -2 * b_, 2 * a_, T(0)},
                         {-2 * b_, -4 * c_, T(0), 2 * a_},
                         {2 * a_, T(0), -4 * c_, 2 * b_},
                         {T(0), 2 * a_, 2 * b_, T(0)}};
#pragma unroll
    for (int i = 0; i < 4; ++i) qzz[6 + i] += dt * (pick(Hqq[i], j) * Tm);
    const T Pj[3] = {pick(P, j, 0), pick(P, j, 1), pick(P, j, 2)};
#pragma unroll
    for (int c = 0; c < 3; ++c) qzz[10 + c] += dt * Pj[c];
    const T hqu[4] = {(2 * y0 * Vz[3] - 2 * x0 * Vz[4]) / m,
                      (2 * z0 * Vz[3] - 2 * w0 * Vz[4] - 4 * x0 * Vz[5]) / m,
                      (2 * w0 * Vz[3] + 2 * z0 * Vz[4] - 4 * y0 * Vz[5]) / m,
                      (2 * x0 * Vz[3] + 2 * y0 * Vz[4]) / m};
    const T hj = pick(hqu, j);
#pragma unroll
    for (int jj = 0; jj < NU; ++jj) quz[jj] += dt * hj;
  } else {  // omega column c: P, Sww
    const int c = cc - 10;
    const T d1 = T(cs.Jz - cs.Jy) * (Vz[10] / Jx);
    const T d2 = T(cs.Jx - cs.Jz) * (Vz[11] / Jy);
    const T d3 = T(cs.Jy - cs.Jx) * (Vz[12] / Jz);
    const T Sww[3][3] = {{T(0), d3, d2}, {d3, T(0), d1}, {d2, d1, T(0)}};
#pragma unroll
    for (int i = 0; i < 4; ++i) qzz[6 + i] += dt * pick(P[i], c);
#pragma unroll
    for (int i = 0; i < 3; ++i) qzz[10 + i] += -dt * pick(Sww[i], c);
  }
}

}  // namespace laf
