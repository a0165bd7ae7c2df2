// K2: fully fused control-limited DDP backward sweep.
//
// Replaces learningagileflight_se3_tpu/ops/riccati_fused.py
// riccati_backward_fused (kernel _make_kernel; helpers _jac_blocks, _At_v,
// _Bt_v, _cost_quadratics_lanes, and riccati_pallas.py _h2_lanes).  Plain
// PyTorch version: ops/riccati_fused.py riccati_backward_plain.
//
// One thread per scenario walks the horizon in reverse.  Per step it reads
// only ZU (21 values) and t_w, and rebuilds from them the nonzero blocks of
// the Jacobians (the augmented A is block-sparse, B has a rank-1 v block, a
// constant omega block and an identity u_prev block) and the closed-form
// cost quadratics; every product below exploits that structure.
//
// Working set per thread: Vzz (17x17), M = Vzz A (13x13 nonzero), Qzz
// (17x17), B^T Vzz and Quz (4x17), K (4x17), K^T Quu (17x4), ~1k values
// (4 KB in f32, 8 KB in f64).  It cannot live in registers and is kept in
// thread-local memory: the hardware interleaves local memory across a warp,
// so each access is one coalesced transaction, cached in L1 / L2.  That
// traffic and its latency bound the kernel.
#include "lane_algebra.cuh"

namespace laf {

template <typename T>
__global__ void __launch_bounds__(BLOCK)
riccati_fused_kernel(const Consts c, const int H, const int B,
                     const T* __restrict__ ZU, const T* __restrict__ tw,
                     const T* __restrict__ goal_p, const T* __restrict__ tp_p,
                     const T* __restrict__ Hatt_p, const T* __restrict__ att0_p,
                     const T* __restrict__ phiz_p, const T* __restrict__ phizz_p,
                     const T* __restrict__ reg_p,
                     T* __restrict__ kk_out, T* __restrict__ KK_out,
                     T* __restrict__ dV1_out, T* __restrict__ dV2_out,
                     T* __restrict__ fail_out, T* __restrict__ pg_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
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
    const double l2 = c.l / 2.0, cc = c.c, J[3] = {c.Jx, c.Jy, c.Jz};
    const double mix[3][4] = {{0.0, -l2, 0.0, l2}, {-l2, 0.0, l2, 0.0}, {cc, -cc, cc, -cc}};
    double md[3][4];
    for (int t = 0; t < 3; ++t)
      for (int j = 0; j < 4; ++j) {
        md[t][j] = c.dt * mix[t][j] / J[t];
        mixj[t][j] = T(md[t][j]);
      }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        mm[i][j] = T(md[0][i] * md[0][j] + md[1][i] * md[1][j] + md[2][i] * md[2][j] +
                     (i == j ? 1.0 : 0.0));
  }
  const T hg[4] = {T(0), T(8), T(8), T(8)};  // Hatt of the identity goal quaternion

  // ---- per-problem data ----
  T goal[3], tp[3], Hatt[4][4];
  for (int i = 0; i < 3; ++i) {
    goal[i] = goal_p[i * sB + b];
    tp[i] = tp_p[i * sB + b];
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) Hatt[i][j] = Hatt_p[(i * 4 + j) * sB + b];
  const T att0 = att0_p[b];
  const T reg = reg_p[b];

  // ---- carries ----
  T Vz[NZ], lam[NZ], Vzz[NZ][NZ];
  for (int i = 0; i < NZ; ++i) {
    Vz[i] = phiz_p[i * sB + b];
    lam[i] = Vz[i];
  }
#pragma unroll 1
  for (int i = 0; i < NZ; ++i)
    for (int j = 0; j < NZ; ++j) Vzz[i][j] = phizz_p[(i * NZ + j) * sB + b];
  T dv1 = T(0), dv2 = T(0), fail = T(0), pg = T(0);

  // ---- per-step scratch ----
  T M[NX][NX], Qzz[NZ][NZ], BtV[NU][NZ], Quz[NU][NZ], K[NU][NZ], KtQuu[NZ][NU];

#pragma unroll 1
  for (int jstep = 0; jstep < H; ++jstep) {
    const int k = H - 1 - jstep;
    T zu[NZU];
    for (int i = 0; i < NZU; ++i) zu[i] = ZU[((size_t)k * NZU + i) * sB + b];
    const T wk = tw[(size_t)k * sB + b];
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
    T lz[NZ], lu[NU], lqq[4][4], d_om[3];
    const T ctp = two_wrt * wk;
    for (int i = 0; i < 3; ++i) lz[i] = ctp * (zu[i] - tp[i]) + two_wrf * (zu[i] - goal[i]);
    const T d_r = ctp + two_wrf;
    for (int i = 0; i < 3; ++i) lz[3 + i] = two_wvf * zu[3 + i];
    const T* q = zu + 6;
    T Hq[4];
    for (int i = 0; i < 4; ++i)
      Hq[i] = Hatt[i][0] * q[0] + Hatt[i][1] * q[1] + Hatt[i][2] * q[2] + Hatt[i][3] * q[3];
    const T att = att0 + T(0.5) * (q[0] * Hq[0] + q[1] * Hq[1] + q[2] * Hq[2] + q[3] * Hq[3]);
    const T wq = wqt * wk;
    for (int i = 0; i < 4; ++i) {
      if (c.squared_attitude) {
        lz[6 + i] = (2 * wq * att) * Hq[i];
        for (int j = 0; j < 4; ++j) lqq[i][j] = (2 * wq) * (Hq[i] * Hq[j] + att * Hatt[i][j]);
      } else {
        lz[6 + i] = wq * Hq[i];
        for (int j = 0; j < 4; ++j) lqq[i][j] = wq * Hatt[i][j];
      }
      if (c.use_wqf) {
        lz[6 + i] += wqf * (hg[i] * q[i]);
        lqq[i][i] += wqf * hg[i];
      }
    }
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
    for (int i = 0; i < NU; ++i) {
      const T du = u[i] - zu[13 + i];
      lz[13 + i] = m2wdu * du;
      lu[i] = two_wthrust * u[i] + two_wdu * du;
    }

    // A^T v and B^T v through the block structure (_At_v, _Bt_v)
    auto At_v = [&](const T* v, T* out) {
      for (int i = 0; i < 3; ++i) {
        out[i] = v[i];
        out[3 + i] = dt * v[i] + v[3 + i];
      }
      for (int cc = 0; cc < 4; ++cc)
        out[6 + cc] = (Sd[0][cc] * v[3] + Sd[1][cc] * v[4] + Sd[2][cc] * v[5]) +
                      (Qq[0][cc] * v[6] + Qq[1][cc] * v[7] + Qq[2][cc] * v[8] + Qq[3][cc] * v[9]);
      for (int cc = 0; cc < 3; ++cc)
        out[10 + cc] = (Gm[0][cc] * v[6] + Gm[1][cc] * v[7] + Gm[2][cc] * v[8] + Gm[3][cc] * v[9]) +
                       (Wm[0][cc] * v[10] + Wm[1][cc] * v[11] + Wm[2][cc] * v[12]);
      for (int i = 13; i < NZ; ++i) out[i] = T(0);
    };
    auto Bt_v = [&](const T* v, T* out) {
      const T shared = bv[0] * v[3] + bv[1] * v[4] + bv[2] * v[5];
      for (int j = 0; j < NU; ++j)
        out[j] = shared + (mixj[0][j] * v[10] + mixj[1][j] * v[11] + mixj[2][j] * v[12]) + v[13 + j];
    };

    // ---- adjoint for the true projected gradient ----
    T tmp[NZ], gu[NU];
    Bt_v(lam, gu);
    T pg_step = T(0);
    for (int i = 0; i < NU; ++i) {
      gu[i] += lu[i];
      const bool at_lo = (u[i] <= lo_g) && (gu[i] > T(0));
      const bool at_hi = (u[i] >= hi_g) && (gu[i] < T(0));
      const T agu = fabs(gu[i]) * ((at_lo || at_hi) ? T(0) : T(1));
      pg_step = i == 0 ? agu : nmax(pg_step, agu);
    }
    pg = nmax(pg, pg_step);
    At_v(lam, tmp);
    for (int i = 0; i < NZ; ++i) lam[i] = lz[i] + tmp[i];

    // ---- Q expansions through the block structure ----
    T Qz[NZ], Qu[NU];
    At_v(Vz, tmp);
    for (int i = 0; i < NZ; ++i) Qz[i] = lz[i] + tmp[i];
    Bt_v(Vz, Qu);
    for (int i = 0; i < NU; ++i) Qu[i] += lu[i];

    // M = Vzz A, rows 0..12 (rows 13..16 never reach Qzz), columns 0..12
    // (columns 13..16 are zero: A's u_prev columns are zero)
#pragma unroll 1
    for (int i = 0; i < NX; ++i) {
      const T* V = Vzz[i];
      for (int cc = 0; cc < 3; ++cc) {
        M[i][cc] = V[cc];
        M[i][3 + cc] = dt * V[cc] + V[3 + cc];
      }
      for (int cc = 0; cc < 4; ++cc)
        M[i][6 + cc] = (V[3] * Sd[0][cc] + V[4] * Sd[1][cc] + V[5] * Sd[2][cc]) +
                       (V[6] * Qq[0][cc] + V[7] * Qq[1][cc] + V[8] * Qq[2][cc] + V[9] * Qq[3][cc]);
      for (int cc = 0; cc < 3; ++cc)
        M[i][10 + cc] = (V[6] * Gm[0][cc] + V[7] * Gm[1][cc] + V[8] * Gm[2][cc] + V[9] * Gm[3][cc]) +
                        (V[10] * Wm[0][cc] + V[11] * Wm[1][cc] + V[12] * Wm[2][cc]);
    }

    // Qzz = lzz + A^T M, row blocks
#pragma unroll 1
    for (int cc = 0; cc < NZ; ++cc) {
      const bool in = cc < NX;
      for (int a = 0; a < 3; ++a) {
        Qzz[a][cc] = (in ? M[a][cc] : T(0)) + (cc == a ? d_r : T(0));
        Qzz[3 + a][cc] = (in ? dt * M[a][cc] + M[3 + a][cc] : T(0)) + (cc == 3 + a ? two_wvf : T(0));
      }
      for (int a = 0; a < 4; ++a)
        Qzz[6 + a][cc] =
            (in ? (Sd[0][a] * M[3][cc] + Sd[1][a] * M[4][cc] + Sd[2][a] * M[5][cc]) +
                      (Qq[0][a] * M[6][cc] + Qq[1][a] * M[7][cc] + Qq[2][a] * M[8][cc] +
                       Qq[3][a] * M[9][cc])
                : T(0)) +
            (cc >= 6 && cc < 10 ? lqq[a][cc - 6] : T(0));
      for (int a = 0; a < 3; ++a)
        Qzz[10 + a][cc] =
            (in ? (Gm[0][a] * M[6][cc] + Gm[1][a] * M[7][cc] + Gm[2][a] * M[8][cc] +
                   Gm[3][a] * M[9][cc]) +
                      (Wm[0][a] * M[10][cc] + Wm[1][a] * M[11][cc] + Wm[2][a] * M[12][cc])
                : T(0)) +
            (cc == 10 + a ? d_om[a] : T(0));
      for (int a = 0; a < NU; ++a) Qzz[13 + a][cc] = cc == 13 + a ? two_wdu : T(0);
    }

    // B^T Vzz: the rank-1 v part is shared across rows
#pragma unroll 1
    for (int cc = 0; cc < NZ; ++cc) {
      const T shared = bv[0] * Vzz[3][cc] + bv[1] * Vzz[4][cc] + bv[2] * Vzz[5][cc];
      for (int j = 0; j < NU; ++j)
        BtV[j][cc] = shared + (mixj[0][j] * Vzz[10][cc] + mixj[1][j] * Vzz[11][cc] +
                               mixj[2][j] * Vzz[12][cc]) + Vzz[13 + j][cc];
    }

    // Quz = luz + (B^T Vzz) A, column blocks; Quu = luu + (B^T Vzz) B
    T Quu[NU][NU];
    for (int j = 0; j < NU; ++j) {
      const T* R = BtV[j];
      for (int cc = 0; cc < 3; ++cc) {
        Quz[j][cc] = R[cc];
        Quz[j][3 + cc] = dt * R[cc] + R[3 + cc];
      }
      for (int cc = 0; cc < 4; ++cc)
        Quz[j][6 + cc] = (R[3] * Sd[0][cc] + R[4] * Sd[1][cc] + R[5] * Sd[2][cc]) +
                         (R[6] * Qq[0][cc] + R[7] * Qq[1][cc] + R[8] * Qq[2][cc] + R[9] * Qq[3][cc]);
      for (int cc = 0; cc < 3; ++cc)
        Quz[j][10 + cc] = (R[6] * Gm[0][cc] + R[7] * Gm[1][cc] + R[8] * Gm[2][cc] + R[9] * Gm[3][cc]) +
                          (R[10] * Wm[0][cc] + R[11] * Wm[1][cc] + R[12] * Wm[2][cc]);
      for (int cc = 0; cc < NU; ++cc) Quz[j][13 + cc] = cc == j ? m2wdu : T(0);
      const T colshared = R[3] * bv[0] + R[4] * bv[1] + R[5] * bv[2];
      for (int jj = 0; jj < NU; ++jj)
        Quu[j][jj] = (colshared + (mixj[0][jj] * R[10] + mixj[1][jj] * R[11] + mixj[2][jj] * R[12]) +
                      R[13 + jj]) + (j == jj ? c_luu : T(0));
    }

    // ---- DDP second-order term (_h2_lanes) with the pre-update Vz ----
    if (c.use_ddp) add_ddp_term(c, zu + 6, u[0] + u[1] + u[2] + u[3], Vz, Qzz, Quz);

    // ---- Tassa regularization via B^T B and B^T A ----
    const T bb = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2];
    T bvSd[4], mjW[NU][3];
    for (int cc = 0; cc < 4; ++cc) bvSd[cc] = Sd[0][cc] * bv[0] + Sd[1][cc] * bv[1] + Sd[2][cc] * bv[2];
    for (int j = 0; j < NU; ++j)
      for (int cc = 0; cc < 3; ++cc)
        mjW[j][cc] = mixj[0][j] * Wm[0][cc] + mixj[1][j] * Wm[1][cc] + mixj[2][j] * Wm[2][cc];
    auto BtA = [&](int j, int cc) -> T {
      if (cc < 3 || cc >= NX) return T(0);
      if (cc < 6) return bv[cc - 3];
      if (cc < 10) return bvSd[cc - 6];
      return mjW[j][cc - 10];
    };
    T Quu_r[NU][NU];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) Quu_r[i][j] = Quu[i][j] + reg * (bb + mm[i][j]);
    for (int i = 0; i < NU; ++i)
      for (int j = i; j < NU; ++j) {
        const T sym = T(0.5) * (Quu_r[i][j] + Quu_r[j][i]);
        Quu_r[i][j] = sym;
        Quu_r[j][i] = sym;
      }

    // ---- boxQP feedforward and masked-Newton gains ----
    T lo[NU], hi[NU], kf[NU], fr[NU];
    for (int i = 0; i < NU; ++i) {
      lo[i] = lb - u[i];
      hi[i] = ub - u[i];
    }
    boxqp(Quu_r, Qu, lo, hi, c.boxqp_iters, kf, fr);
    T Mm[4][4];
    masked4(Quu_r, fr, Mm);
    const Chol4<T> L4 = chol4(Mm);
#pragma unroll 1
    for (int cc = 0; cc < NZ; ++cc) {
      T rhs[NU], x[NU];
      for (int j = 0; j < NU; ++j) rhs[j] = (Quz[j][cc] + reg * BtA(j, cc)) * fr[j];
      chol4_solve(L4, rhs, x);
      for (int j = 0; j < NU; ++j) K[j][cc] = -x[j] * fr[j];
    }
    fail = nmax(fail, L4.ok ? T(0) : T(1));

    // ---- value recursion ----
    T Quu_kf[NU];
    mat_vec4(Quu, kf, Quu_kf);
    for (int cc = 0; cc < NZ; ++cc) {
      const T KtQuuk = K[0][cc] * Quu_kf[0] + K[1][cc] * Quu_kf[1] + K[2][cc] * Quu_kf[2] + K[3][cc] * Quu_kf[3];
      const T KtQu = K[0][cc] * Qu[0] + K[1][cc] * Qu[1] + K[2][cc] * Qu[2] + K[3][cc] * Qu[3];
      const T QuzTkf = Quz[0][cc] * kf[0] + Quz[1][cc] * kf[1] + Quz[2][cc] * kf[2] + Quz[3][cc] * kf[3];
      Vz[cc] = Qz[cc] + KtQuuk + KtQu + QuzTkf;
      for (int j = 0; j < NU; ++j)
        KtQuu[cc][j] = K[0][cc] * Quu[0][j] + K[1][cc] * Quu[1][j] + K[2][cc] * Quu[2][j] + K[3][cc] * Quu[3][j];
    }
    // Vzz <- sym(Qzz + K^T Quu K + K^T Quz + Quz^T K); the old Vzz is dead
#pragma unroll 1
    for (int a = 0; a < NZ; ++a) {
      for (int bcol = a; bcol < NZ; ++bcol) {
        const T kqk_ab = KtQuu[a][0] * K[0][bcol] + KtQuu[a][1] * K[1][bcol] + KtQuu[a][2] * K[2][bcol] + KtQuu[a][3] * K[3][bcol];
        const T kqk_ba = KtQuu[bcol][0] * K[0][a] + KtQuu[bcol][1] * K[1][a] + KtQuu[bcol][2] * K[2][a] + KtQuu[bcol][3] * K[3][a];
        const T kqz_ab = K[0][a] * Quz[0][bcol] + K[1][a] * Quz[1][bcol] + K[2][a] * Quz[2][bcol] + K[3][a] * Quz[3][bcol];
        const T kqz_ba = K[0][bcol] * Quz[0][a] + K[1][bcol] * Quz[1][a] + K[2][bcol] * Quz[2][a] + K[3][bcol] * Quz[3][a];
        const T v_ab = Qzz[a][bcol] + kqk_ab + kqz_ab + kqz_ba;
        const T v_ba = Qzz[bcol][a] + kqk_ba + kqz_ba + kqz_ab;
        const T sym = T(0.5) * (v_ab + v_ba);
        Vzz[a][bcol] = sym;
        Vzz[bcol][a] = sym;
      }
    }
    dv1 += kf[0] * Qu[0] + kf[1] * Qu[1] + kf[2] * Qu[2] + kf[3] * Qu[3];
    dv2 += T(0.5) * (kf[0] * Quu_kf[0] + kf[1] * Quu_kf[1] + kf[2] * Quu_kf[2] + kf[3] * Quu_kf[3]);

    for (int i = 0; i < NU; ++i) kk_out[((size_t)k * NU + i) * sB + b] = kf[i];
#pragma unroll 1
    for (int i = 0; i < NU; ++i)
      for (int cc = 0; cc < NZ; ++cc) KK_out[(((size_t)k * NU + i) * NZ + cc) * sB + b] = K[i][cc];
  }
  dV1_out[b] = dv1;
  dV2_out[b] = dv2;
  fail_out[b] = fail;
  pg_out[b] = pg;
}

template <typename T>
int launch_riccati_fused(const Consts* c, int H, int B, const T* ZU, const T* tw, const T* goal,
                         const T* tp, const T* Hatt, const T* att0, const T* phiz,
                         const T* phizz, const T* reg, T* kk, T* KK, T* dV1, T* dV2, T* fail,
                         T* pg, cudaStream_t stream) {
  if (B == 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  riccati_fused_kernel<T><<<grid, BLOCK, 0, stream>>>(*c, H, B, ZU, tw, goal, tp, Hatt, att0,
                                                      phiz, phizz, reg, kk, KK, dV1, dV2, fail,
                                                      pg);
  return (int)cudaGetLastError();
}

}  // namespace laf

extern "C" {

int laf_riccati_fused_f32(const laf::Consts* c, int H, int B, const float* ZU, const float* tw,
                          const float* goal, const float* tp, const float* Hatt,
                          const float* att0, const float* phiz, const float* phizz,
                          const float* reg, float* kk, float* KK, float* dV1, float* dV2,
                          float* fail, float* pg, cudaStream_t stream) {
  return laf::launch_riccati_fused<float>(c, H, B, ZU, tw, goal, tp, Hatt, att0, phiz, phizz,
                                          reg, kk, KK, dV1, dV2, fail, pg, stream);
}

int laf_riccati_fused_f64(const laf::Consts* c, int H, int B, const double* ZU,
                          const double* tw, const double* goal, const double* tp,
                          const double* Hatt, const double* att0, const double* phiz,
                          const double* phizz, const double* reg, double* kk, double* KK,
                          double* dV1, double* dV2, double* fail, double* pg,
                          cudaStream_t stream) {
  return laf::launch_riccati_fused<double>(c, H, B, ZU, tw, goal, tp, Hatt, att0, phiz, phizz,
                                           reg, kk, KK, dV1, dV2, fail, pg, stream);
}

}  // extern "C"
