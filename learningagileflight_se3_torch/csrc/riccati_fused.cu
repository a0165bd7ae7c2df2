// K2: fully fused control-limited DDP backward sweep, one warp per scenario.
//
// Replaces learningagileflight_se3_tpu/ops/riccati_fused.py
// riccati_backward_fused (kernel _make_kernel; helpers _jac_blocks, _At_v,
// _Bt_v, _cost_quadratics_lanes, and riccati_pallas.py _h2_lanes).  Plain
// PyTorch version: ops/riccati_fused.py riccati_backward_plain.
//
// Bound on the H100.  Per scenario it reads ZU (21 values a step), t_w (1)
// and 313 values of per-problem data and of the terminal value function,
// and writes kk (4 a step), KK (68) and 4 scalars: B (94 H + 334) values,
// 41.2 MB in f32 at H=50, B=2048, or 12 us at 3.35 TB/s.  Its arithmetic is
// about 13.0k flops per scenario and step (the symmetric Vzz update 5.5k,
// M = Vzz A and Qzz = A^T M 1.3k each, the boxQP 1.05k over the 3 of its 6
// iterations it takes on average; count in chip_smoke.py K2_FLOPS), 1.33
// GFLOP there, or 20 us at the 67 TFLOP/s f32 rate outside the tensor cores:
// bound by operations, about 20 us.
//
// What holds such a sweep back is that each scenario is 50 dependent steps
// over a ~1,000-value working set, too large for one thread's registers.
// One warp takes one scenario, K2_WARPS warps a block, the ragged edge
// masked by scenario:
//  - The working set lives in shared memory, per warp: Vzz (17x17),
//    M = Vzz A (13x13), Qzz (17x17), B^T Vzz (4x17), K and Quz (as 17 rows
//    of 4), Vz, lam, and a two-stage ring for one step's ZU and t_w: 1,029
//    values, 4.1 KB in f32 and 8.2 KB in f64.  Vzz, Qzz and M keep their odd
//    row strides (17 and 13 words), so a lane per row and a lane per column
//    both read without bank conflicts; the rows of K^T and Quz^T are
//    16-byte aligned, one vector load each.
//  - The 17-wide products are split over the lanes: lane i computes row i
//    of M, lane cc column cc of Qzz, B^T Vzz, Quz and K, entry cc of Vz and
//    lam and row cc of K^T Quu (kept in its registers), and lane a row a of
//    the new Vzz; __syncwarp() between phases.  Quu's 16 entries come from
//    16 lanes and are shuffled to all.  The other scalar parts (Jacobian
//    blocks, cost quadratics, the Tassa term, the boxQP and Cholesky) are
//    computed by every lane from the same shared inputs.
//  - Each entry is computed by one lane with one fixed expression; the
//    symmetric Vzz entry 0.5 (v_ab + v_ba) takes v_ba from lane b's row, the
//    same expression, so each product is formed once.  Against the plain
//    version the triangular solves multiply by reciprocal pivots and f32
//    division and square root are the fast forms (ops/build.py), which move
//    results by a few ulps; the boxQP stops once an iteration leaves its
//    iterate in place, which moves none.
//  - While step k computes, step k-1's ZU and t_w are in flight (cp.async,
//    one value a lane).
// B=2048 gives 512 blocks of 4 warps, 16 warps per SM at the f32 kernel's
// 128 registers; B=1 one warp, whose 17 busy lanes split every 17-wide
// product.  What bounds it at B=2048 is instruction issue and the
// dependent chains of the scalar parts, which every lane runs.
#include "lane_algebra.cuh"

namespace laf {

constexpr int K2_WARPS = 4;   // scenarios (warps) per block
// Blocks per SM the f32 kernel is built for: 4 (128 registers a thread) puts
// all 2048 warps of the bench.py batch on the card at once (16 per SM); the
// f64 kernel, off the timed paths, keeps its registers.
template <typename T>
constexpr int k2_min_blocks() {
  return sizeof(T) == 4 ? 4 : 1;
}
constexpr int MS = NX;        // row stride of M
constexpr int ZUS = NZU + 1;  // one ring stage: ZU, then t_w

// One warp's working set (row-major, the strides above); Kt and Quzt hold
// K^T and Quz^T, row cc written by lane cc.
template <typename T>
struct K2Warp {
  alignas(16) T Kt[NZ][NU];
  alignas(16) T Quzt[NZ][NU];
  T Vzz[NZ * NZ], M[NX * MS], Qzz[NZ * NZ], BtV[NU * NZ];
  T Vz[NZ], lam[NZ], zu[2][ZUS];
};

// 4 values at a 16-byte-aligned shared address, in vector accesses.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T v[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const double2 x = reinterpret_cast<const double2*>(p)[0];
    const double2 y = reinterpret_cast<const double2*>(p)[1];
    v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T v[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(K2_WARPS * 32, k2_min_blocks<T>())
riccati_fused_kernel(const Consts c, const int H, const int B,
                     const T* __restrict__ ZU, const T* __restrict__ tw,
                     const T* __restrict__ goal_p, const T* __restrict__ tp_p,
                     const T* __restrict__ Hatt_p, const T* __restrict__ att0_p,
                     const T* __restrict__ phiz_p, const T* __restrict__ phizz_p,
                     const T* __restrict__ reg_p,
                     T* __restrict__ kk_out, T* __restrict__ KK_out,
                     T* __restrict__ dV1_out, T* __restrict__ dV2_out,
                     unsigned char* __restrict__ fail_out, T* __restrict__ pg_out) {
  __shared__ K2Warp<T> smem[K2_WARPS];
  const int b = blockIdx.x * K2_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no lane of a live scenario is masked
  K2Warp<T>& w = smem[threadIdx.x >> 5];
  const int cc = threadIdx.x & 31;  // this lane's row / column / entry
  const bool col = cc < NZ;
  const size_t sB = (size_t)B;

  // ---- constants (folded in double, as the JAX kernel folds host floats) ----
  const T dt = T(c.dt), hdt = T(0.5 * c.dt), m = T(c.mass);
  const T Jx = T(c.Jx), Jy = T(c.Jy), Jz = T(c.Jz);
  const T lb = T(c.lb), ub = T(c.ub);
  const T lo_g = T(c.lb + 1e-7 * (c.ub - c.lb)), hi_g = T(c.ub - 1e-7 * (c.ub - c.lb));
  const T wmz = T(-c.dt * (c.Jz - c.Jy)), wmx = T(-c.dt * (c.Jx - c.Jz));
  const T wmy = T(-c.dt * (c.Jy - c.Jx));
  const T two_wrt = T(2.0 * c.wrt), two_wrf = T(2.0 * c.wrf), two_wvf = T(2.0 * c.wvf);
  const T two_wwf = T(2.0 * c.wwf), two_wbw = T(2.0 * c.w_bound_weight);
  const T wqt = T(c.wqt), wqf = T(c.wqf), w_bound = T(c.w_bound);
  const T two_wthrust = T(2.0 * c.wthrust), two_wdu = T(2.0 * c.w_du);
  const T m2wdu = T(-2.0 * c.w_du);
  const T c_luu = T(2.0 * (c.wthrust + c.w_du));
  const bool wbound_on = c.w_bound_weight > 0.0;
  // omega block of B: dt * J^-1 * mixer (3x4), and mixj^T mixj (4x4)
  T mixj[3][4], mm[4][4];
  {
    const double l2 = c.l / 2.0, cq = c.c, J[3] = {c.Jx, c.Jy, c.Jz};
    const double mix[3][4] = {{0.0, -l2, 0.0, l2}, {-l2, 0.0, l2, 0.0}, {cq, -cq, cq, -cq}};
    double md[3][4];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        md[t][j] = c.dt * mix[t][j] / J[t];
        mixj[t][j] = T(md[t][j]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mm[i][j] = T(md[0][i] * md[0][j] + md[1][i] * md[1][j] + md[2][i] * md[2][j] +
                     (i == j ? 1.0 : 0.0));
  }
  const T hg[4] = {T(0), T(8), T(8), T(8)};  // Hatt of the identity goal quaternion

  // ---- per-problem data (every lane loads the same address: one request) ----
  T goal[3], tp[3], Hatt[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    goal[i] = goal_p[i * sB + b];
    tp[i] = tp_p[i * sB + b];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Hatt[i][j] = Hatt_p[(i * 4 + j) * sB + b];
  const T att0 = att0_p[b];
  const T reg = reg_p[b];

  // ---- carries, in shared memory ----
  if (col) {
    const T v = phiz_p[cc * sB + b];
    w.Vz[cc] = v;
    w.lam[cc] = v;
  }
  for (int idx = cc; idx < NZ * NZ; idx += 32) w.Vzz[idx] = phizz_p[idx * sB + b];
  T dv1 = T(0), dv2 = T(0), fail = T(0), pg = T(0);

  // one step's ZU and t_w into ring stage s, one value a lane
  auto fetch = [&](int k, int s) {
    if (cc < NZU)
      cp_async<sizeof(T)>(&w.zu[s][cc], ZU + ((size_t)k * NZU + cc) * sB + b);
    else if (cc == NZU)
      cp_async<sizeof(T)>(&w.zu[s][NZU], tw + (size_t)k * sB + b);
    cp_async_commit();
  };
  if (H > 0) fetch(H - 1, 0);

#pragma unroll 1
  for (int jstep = 0; jstep < H; ++jstep) {
    const int k = H - 1 - jstep, st = jstep & 1;
    if (jstep + 1 < H)
      fetch(k - 1, st ^ 1);  // stage st^1 was last read before this step's barriers
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // step k's ZU from every lane; the last step's Vzz, Vz, lam
    T zu[NZU];
#pragma unroll
    for (int i = 0; i < NZU; ++i) zu[i] = w.zu[st][i];
    const T wk = w.zu[st][NZU];
    const T w0 = zu[6], x0 = zu[7], y0 = zu[8], z0 = zu[9];
    const T ox = zu[10], oy = zu[11], oz = zu[12];
    const T* u = zu + NZ;

    // ---- Jacobian blocks (_jac_blocks) ----
    const T s = dt * (u[0] + u[1] + u[2] + u[3]) / m;
    const T Sd[3][4] = {{2 * y0 * s, 2 * z0 * s, 2 * w0 * s, 2 * x0 * s},
                        {-2 * x0 * s, -2 * w0 * s, 2 * z0 * s, 2 * y0 * s},
                        {T(0), -4 * x0 * s, -4 * y0 * s, T(0)}};
    const T Qq[4][4] = {{T(1), -hdt * ox, -hdt * oy, -hdt * oz},
                        {hdt * ox, T(1), hdt * oz, -hdt * oy},
                        {hdt * oy, -hdt * oz, T(1), hdt * ox},
                        {hdt * oz, hdt * oy, -hdt * ox, T(1)}};
    const T Gm[4][3] = {{hdt * -x0, hdt * -y0, hdt * -z0},
                        {hdt * w0, hdt * -z0, hdt * y0},
                        {hdt * z0, hdt * w0, hdt * -x0},
                        {hdt * -y0, hdt * x0, hdt * w0}};
    const T Wm[3][3] = {{T(1), wmz * oz / Jx, wmz * oy / Jx},
                        {wmx * oz / Jy, T(1), wmx * ox / Jy},
                        {wmy * oy / Jz, wmy * ox / Jz, T(1)}};
    const T bdm = T(c.dt / c.mass);
    const T bv[3] = {bdm * (2 * (x0 * z0 + w0 * y0)), bdm * (2 * (y0 * z0 - w0 * x0)),
                     bdm * (1 - 2 * (x0 * x0 + y0 * y0))};

    // ---- cost quadratics (_cost_quadratics_lanes) ----
    T lz[NZ], lu[NU], d_om[3];
    const T ctp = two_wrt * wk;
#pragma unroll
    for (int i = 0; i < 3; ++i) lz[i] = ctp * (zu[i] - tp[i]) + two_wrf * (zu[i] - goal[i]);
    const T d_r = ctp + two_wrf;
#pragma unroll
    for (int i = 0; i < 3; ++i) lz[3 + i] = two_wvf * zu[3 + i];
    const T* q = zu + 6;
    T Hq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Hq[i] = Hatt[i][0] * q[0] + Hatt[i][1] * q[1] + Hatt[i][2] * q[2] + Hatt[i][3] * q[3];
    const T att = att0 + T(0.5) * (q[0] * Hq[0] + q[1] * Hq[1] + q[2] * Hq[2] + q[3] * Hq[3]);
    const T wq = wqt * wk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lz[6 + i] = c.squared_attitude ? (2 * wq * att) * Hq[i] : wq * Hq[i];
      if (c.use_wqf) lz[6 + i] += wqf * (hg[i] * q[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T om = zu[10 + i];
      lz[10 + i] = two_wwf * om;
      d_om[i] = two_wwf;
      if (wbound_on) {
        const T viol = nmax(fabs(om) - w_bound, T(0));
        lz[10 + i] += two_wbw * viol * sgn(om);
        d_om[i] += two_wbw * (viol > T(0) ? T(1) : T(0));
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const T du = u[i] - zu[13 + i];
      lz[13 + i] = m2wdu * du;
      lu[i] = two_wthrust * u[i] + two_wdu * du;
    }

    // A^T v and B^T v through the block structure (_At_v, _Bt_v)
    auto At_v = [&](const T* v, T* out) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        out[i] = v[i];
        out[3 + i] = dt * v[i] + v[3 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[6 + j] = (Sd[0][j] * v[3] + Sd[1][j] * v[4] + Sd[2][j] * v[5]) +
                     (Qq[0][j] * v[6] + Qq[1][j] * v[7] + Qq[2][j] * v[8] + Qq[3][j] * v[9]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[10 + j] = (Gm[0][j] * v[6] + Gm[1][j] * v[7] + Gm[2][j] * v[8] + Gm[3][j] * v[9]) +
                      (Wm[0][j] * v[10] + Wm[1][j] * v[11] + Wm[2][j] * v[12]);
#pragma unroll
      for (int i = 13; i < NZ; ++i) out[i] = T(0);
    };
    auto Bt_v = [&](const T* v, T* out) {
      const T shared = bv[0] * v[3] + bv[1] * v[4] + bv[2] * v[5];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        out[j] = shared + (mixj[0][j] * v[10] + mixj[1][j] * v[11] + mixj[2][j] * v[12]) + v[13 + j];
    };

    // ---- adjoint for the true projected gradient (lam written below) ----
    T tmp[NZ], gu[NU];
    Bt_v(w.lam, gu);
    T pg_step = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      gu[i] += lu[i];
      const bool at_lo = (u[i] <= lo_g) && (gu[i] > T(0));
      const bool at_hi = (u[i] >= hi_g) && (gu[i] < T(0));
      const T agu = fabs(gu[i]) * ((at_lo || at_hi) ? T(0) : T(1));
      pg_step = i == 0 ? agu : nmax(pg_step, agu);
    }
    pg = nmax(pg, pg_step);
    At_v(w.lam, tmp);
    const T lz_own = pick(lz, cc);
    const T lam_new = lz_own + pick(tmp, cc);

    // ---- Q expansions through the block structure ----
    T Qu[NU];
    At_v(w.Vz, tmp);
    const T Qz_own = lz_own + pick(tmp, cc);
    Bt_v(w.Vz, Qu);
#pragma unroll
    for (int i = 0; i < NU; ++i) Qu[i] += lu[i];

    // M = Vzz A, row cc (rows 13..16 never reach Qzz; columns 13..16 are
    // zero: A's u_prev columns are zero)
    if (cc < NX) {
      const T* V = w.Vzz + cc * NZ;
      T* Mr = w.M + cc * MS;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Mr[j] = V[j];
        Mr[3 + j] = dt * V[j] + V[3 + j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Mr[6 + j] = (V[3] * Sd[0][j] + V[4] * Sd[1][j] + V[5] * Sd[2][j]) +
                    (V[6] * Qq[0][j] + V[7] * Qq[1][j] + V[8] * Qq[2][j] + V[9] * Qq[3][j]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Mr[10 + j] = (V[6] * Gm[0][j] + V[7] * Gm[1][j] + V[8] * Gm[2][j] + V[9] * Gm[3][j]) +
                     (V[10] * Wm[0][j] + V[11] * Wm[1][j] + V[12] * Wm[2][j]);
    }
    __syncwarp();

    // Qzz = lzz + A^T M, column cc (kept in registers); B^T Vzz, column cc
    // (the rank-1 v part shared across rows)
    T qzz[NZ], quz[NU] = {T(0), T(0), T(0), T(0)};
    if (col) {
      const bool in = cc < NX;
      const T* Mc = w.M + (in ? cc : 0);
      // column lc of the attitude cost's Hessian lqq, for a quaternion column
      const int lc = (cc >= 6 && cc < 10) ? cc - 6 : 0;
      const T Hq_c = pick(Hq, lc);
      T lqc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        lqc[a] = c.squared_attitude ? (2 * wq) * (Hq[a] * Hq_c + att * pick(Hatt[a], lc))
                                    : wq * pick(Hatt[a], lc);
        if (c.use_wqf && a == lc) lqc[a] += wqf * hg[a];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        qzz[a] = (in ? Mc[a * MS] : T(0)) + (cc == a ? d_r : T(0));
        qzz[3 + a] = (in ? dt * Mc[a * MS] + Mc[(3 + a) * MS] : T(0)) + (cc == 3 + a ? two_wvf : T(0));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qzz[6 + a] =
            (in ? (Sd[0][a] * Mc[3 * MS] + Sd[1][a] * Mc[4 * MS] + Sd[2][a] * Mc[5 * MS]) +
                      (Qq[0][a] * Mc[6 * MS] + Qq[1][a] * Mc[7 * MS] + Qq[2][a] * Mc[8 * MS] +
                       Qq[3][a] * Mc[9 * MS])
                : T(0)) +
            (cc >= 6 && cc < 10 ? lqc[a] : T(0));
#pragma unroll
      for (int a = 0; a < 3; ++a)
        qzz[10 + a] =
            (in ? (Gm[0][a] * Mc[6 * MS] + Gm[1][a] * Mc[7 * MS] + Gm[2][a] * Mc[8 * MS] +
                   Gm[3][a] * Mc[9 * MS]) +
                      (Wm[0][a] * Mc[10 * MS] + Wm[1][a] * Mc[11 * MS] + Wm[2][a] * Mc[12 * MS])
                : T(0)) +
            (cc == 10 + a ? d_om[a] : T(0));
#pragma unroll
      for (int a = 0; a < NU; ++a) qzz[13 + a] = cc == 13 + a ? two_wdu : T(0);

      const T* Vc = w.Vzz + cc;
      const T shared = bv[0] * Vc[3 * NZ] + bv[1] * Vc[4 * NZ] + bv[2] * Vc[5 * NZ];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        w.BtV[j * NZ + cc] = shared + (mixj[0][j] * Vc[10 * NZ] + mixj[1][j] * Vc[11 * NZ] +
                                       mixj[2][j] * Vc[12 * NZ]) + Vc[(13 + j) * NZ];
    }
    __syncwarp();

    // Quz = luz + (B^T Vzz) A, column cc; then the DDP second-order term
    // (_h2_lanes) with the pre-update Vz on both columns
    if (col) {
      // one branch per block of A's columns, each over the four rows, so a
      // branch's loads of B^T Vzz overlap
      const T* R = w.BtV;
      if (cc < 3) {
#pragma unroll
        for (int j = 0; j < NU; ++j) quz[j] = R[j * NZ + cc];
      } else if (cc < 6) {
#pragma unroll
        for (int j = 0; j < NU; ++j) quz[j] = dt * R[j * NZ + cc - 3] + R[j * NZ + cc];
      } else if (cc < 10) {
        const int i = cc - 6;
        const T s0 = pick(Sd[0], i), s1 = pick(Sd[1], i), s2 = pick(Sd[2], i);
        const T q0 = pick(Qq[0], i), q1 = pick(Qq[1], i), q2 = pick(Qq[2], i), q3 = pick(Qq[3], i);
#pragma unroll
        for (int j = 0; j < NU; ++j, R += NZ)
          quz[j] = (R[3] * s0 + R[4] * s1 + R[5] * s2) + (R[6] * q0 + R[7] * q1 + R[8] * q2 + R[9] * q3);
      } else if (cc < NX) {
        const int i = cc - 10;
        const T g0 = pick(Gm[0], i), g1 = pick(Gm[1], i), g2 = pick(Gm[2], i), g3 = pick(Gm[3], i);
        const T w0_ = pick(Wm[0], i), w1_ = pick(Wm[1], i), w2_ = pick(Wm[2], i);
#pragma unroll
        for (int j = 0; j < NU; ++j, R += NZ)
          quz[j] = (R[6] * g0 + R[7] * g1 + R[8] * g2 + R[9] * g3) + (R[10] * w0_ + R[11] * w1_ + R[12] * w2_);
      } else {
#pragma unroll
        for (int j = 0; j < NU; ++j) quz[j] = cc - 13 == j ? m2wdu : T(0);
      }
      if (c.use_ddp) add_ddp_term_col(c, q, u[0] + u[1] + u[2] + u[3], w.Vz, cc, qzz, quz);
#pragma unroll
      for (int a = 0; a < NZ; ++a) w.Qzz[a * NZ + cc] = qzz[a];
      store4(w.Quzt[cc], quz);
    }
    // Quu = luu + (B^T Vzz) B: entry (j, jj) from lane 4 j + jj, then to all
    T quu_l = T(0);
    if (cc < NU * NU) {
      const int j = cc >> 2, jj = cc & 3;
      const T* R = w.BtV + j * NZ;
      const T colshared = R[3] * bv[0] + R[4] * bv[1] + R[5] * bv[2];
      quu_l = (colshared + (pick(mixj[0], jj) * R[10] + pick(mixj[1], jj) * R[11] +
                            pick(mixj[2], jj) * R[12]) + R[13 + jj]) + (j == jj ? c_luu : T(0));
    }
    T Quu[NU][NU];
#pragma unroll
    for (int j = 0; j < NU; ++j)
#pragma unroll
      for (int jj = 0; jj < NU; ++jj) Quu[j][jj] = __shfl_sync(0xffffffffu, quu_l, j * NU + jj);

    // ---- Tassa regularization via B^T B and B^T A ----
    const T bb = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2];
    T bvSd[4], mjW[NU][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) bvSd[j] = Sd[0][j] * bv[0] + Sd[1][j] * bv[1] + Sd[2][j] * bv[2];
#pragma unroll
    for (int j = 0; j < NU; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        mjW[j][i] = mixj[0][j] * Wm[0][i] + mixj[1][j] * Wm[1][i] + mixj[2][j] * Wm[2][i];
    T Quu_r[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) Quu_r[i][j] = Quu[i][j] + reg * (bb + mm[i][j]);
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = i; j < NU; ++j) {
        const T sym = T(0.5) * (Quu_r[i][j] + Quu_r[j][i]);
        Quu_r[i][j] = sym;
        Quu_r[j][i] = sym;
      }

    // ---- boxQP feedforward and masked-Newton gains, column cc of K ----
    T lo[NU], hi[NU], kf[NU], fr[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lo[i] = lb - u[i];
      hi[i] = ub - u[i];
    }
    boxqp(Quu_r, Qu, lo, hi, c.boxqp_iters, kf, fr);
    T Mm[4][4];
    masked4(Quu_r, fr, Mm);
    const Chol4<T> L4 = chol4(Mm);
    T Kc[NU];
    {
      // B^T A at (j, cc): zero but for the v, quaternion and omega columns
      const int iv = (cc >= 3 && cc < 6) ? cc - 3 : 0;
      const int iq = (cc >= 6 && cc < 10) ? cc - 6 : 0;
      const int iw = (cc >= 10 && cc < NX) ? cc - 10 : 0;
      T rhs[NU], x[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const T bta = (cc < 3 || cc >= NX) ? T(0)
                      : cc < 6             ? pick(bv, iv)
                      : cc < 10            ? pick(bvSd, iq)
                                           : pick(mjW[j], iw);
        rhs[j] = (quz[j] + reg * bta) * fr[j];
      }
      chol4_solve(L4, rhs, x);
#pragma unroll
      for (int j = 0; j < NU; ++j) Kc[j] = -x[j] * fr[j];
    }
    fail = nmax(fail, L4.ok ? T(0) : T(1));

    // ---- value recursion: entry cc of Vz, row cc of K^T Quu ----
    T Quu_kf[NU];
    mat_vec4(Quu, kf, Quu_kf);
    T Vz_new = T(0), kq[NU];
    if (col) {
      const T KtQuuk = Kc[0] * Quu_kf[0] + Kc[1] * Quu_kf[1] + Kc[2] * Quu_kf[2] + Kc[3] * Quu_kf[3];
      const T KtQu = Kc[0] * Qu[0] + Kc[1] * Qu[1] + Kc[2] * Qu[2] + Kc[3] * Qu[3];
      const T QuzTkf = quz[0] * kf[0] + quz[1] * kf[1] + quz[2] * kf[2] + quz[3] * kf[3];
      Vz_new = Qz_own + KtQuuk + KtQu + QuzTkf;
#pragma unroll
      for (int j = 0; j < NU; ++j)
        kq[j] = Kc[0] * Quu[0][j] + Kc[1] * Quu[1][j] + Kc[2] * Quu[2][j] + Kc[3] * Quu[3][j];
      store4(w.Kt[cc], Kc);
    }
    __syncwarp();  // Qzz, Quz, K complete; every lane is done with Vz, lam, Vzz

    // Vzz <- sym(Qzz + K^T Quu K + K^T Quz + Quz^T K), entry (a, b) =
    // 0.5 (v_ab + v_ba), v_ab = Qzz[a][b] + kqk_ab + kqz_ab + kqz_ba.  Lane a
    // turns row a of Qzz into v_a., in place; v_ba is then the entry lane b
    // wrote, the same expression, so each product is formed once.
    if (col) {
      w.Vz[cc] = Vz_new;
      w.lam[cc] = lam_new;
      T* va = w.Qzz + cc * NZ;  // K[j][a] = Kc[j], Quz[j][a] = quz[j], (K^T Quu)[a][j] = kq[j]
#pragma unroll
      for (int bcol = 0; bcol < NZ; ++bcol) {
        T Kb[NU], Qub[NU];
        load4(w.Kt[bcol], Kb);
        load4(w.Quzt[bcol], Qub);
        const T kqk_ab = kq[0] * Kb[0] + kq[1] * Kb[1] + kq[2] * Kb[2] + kq[3] * Kb[3];
        const T kqz_ab = Kc[0] * Qub[0] + Kc[1] * Qub[1] + Kc[2] * Qub[2] + Kc[3] * Qub[3];
        const T kqz_ba = Kb[0] * quz[0] + Kb[1] * quz[1] + Kb[2] * quz[2] + Kb[3] * quz[3];
        va[bcol] = va[bcol] + kqk_ab + kqz_ab + kqz_ba;
      }
    }
    __syncwarp();
    if (col) {
#pragma unroll
      for (int bcol = 0; bcol < NZ; ++bcol)
        w.Vzz[cc * NZ + bcol] = T(0.5) * (w.Qzz[cc * NZ + bcol] + w.Qzz[bcol * NZ + cc]);
    }
    dv1 += kf[0] * Qu[0] + kf[1] * Qu[1] + kf[2] * Qu[2] + kf[3] * Qu[3];
    dv2 += T(0.5) * (kf[0] * Quu_kf[0] + kf[1] * Quu_kf[1] + kf[2] * Quu_kf[2] + kf[3] * Quu_kf[3]);

    if (cc < NU) kk_out[((size_t)k * NU + cc) * sB + b] = pick(kf, cc);
    if (col) {
#pragma unroll
      for (int j = 0; j < NU; ++j) KK_out[(((size_t)k * NU + j) * NZ + cc) * sB + b] = Kc[j];
    }
  }
  if (cc == 0) {
    dV1_out[b] = dv1;
    dV2_out[b] = dv2;
    fail_out[b] = fail > T(0);
    pg_out[b] = pg;
  }
}

template <typename T>
int launch_riccati_fused(const Consts* c, int H, int B, const T* ZU, const T* tw, const T* goal,
                         const T* tp, const T* Hatt, const T* att0, const T* phiz,
                         const T* phizz, const T* reg, T* kk, T* KK, T* dV1, T* dV2, unsigned char* fail,
                         T* pg, cudaStream_t stream) {
  if (B == 0) return 0;
  const int grid = (B + K2_WARPS - 1) / K2_WARPS;
  riccati_fused_kernel<T><<<grid, K2_WARPS * 32, 0, stream>>>(*c, H, B, ZU, tw, goal, tp, Hatt,
                                                              att0, phiz, phizz, reg, kk, KK, dV1,
                                                              dV2, fail, pg);
  return (int)cudaGetLastError();
}

}  // namespace laf

extern "C" {

int laf_riccati_fused_f32(const laf::Consts* c, int H, int B, const float* ZU, const float* tw,
                          const float* goal, const float* tp, const float* Hatt,
                          const float* att0, const float* phiz, const float* phizz,
                          const float* reg, float* kk, float* KK, float* dV1, float* dV2,
                          unsigned char* fail, float* pg, cudaStream_t stream) {
  return laf::launch_riccati_fused<float>(c, H, B, ZU, tw, goal, tp, Hatt, att0, phiz, phizz,
                                          reg, kk, KK, dV1, dV2, fail, pg, stream);
}

int laf_riccati_fused_f64(const laf::Consts* c, int H, int B, const double* ZU,
                          const double* tw, const double* goal, const double* tp,
                          const double* Hatt, const double* att0, const double* phiz,
                          const double* phizz, const double* reg, double* kk, double* KK,
                          double* dV1, double* dV2, unsigned char* fail, double* pg,
                          cudaStream_t stream) {
  return laf::launch_riccati_fused<double>(c, H, B, ZU, tw, goal, tp, Hatt, att0, phiz, phizz,
                                           reg, kk, KK, dV1, dV2, fail, pg, stream);
}

}  // extern "C"
