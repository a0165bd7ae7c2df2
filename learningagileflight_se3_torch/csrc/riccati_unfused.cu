// K3: the control-limited DDP backward sweep over precomputed derivatives.
//
// Replaces learningagileflight_se3_tpu/ops/riccati_pallas.py
// riccati_backward_pallas (kernel _make_kernel).  Plain PyTorch version:
// ops/riccati_unfused.py riccati_unfused_plain.  The same sweep as K2
// (riccati_fused.cu: fused adjoint for the true projected gradient, Q
// expansions, DDP term, Tassa regularization through B^T B and B^T A, boxQP,
// masked-Cholesky gains, value recursion), except that the Jacobians A, B
// and the cost quadratics are read from device memory instead of formed
// from the trajectory, and the products are dense.
//
// One thread per scenario walks the horizon in reverse (blocks of one warp,
// the ragged last block masked).  Per step a lane reads about 776
// values (A 289, lzz 289, B 68, luz 68, lz 17, luu 16, lu 4, U 4, ZU 8 of
// 21): 3.1 KB in f32, 318 MB for H=50, B=2048, about 0.1 ms at full HBM
// bandwidth.  The batch-last layout makes each of a warp's loads one
// coalesced transaction.  What bounds the kernel is latency: 50
// dependent steps of ~12k dense FLOPs each, one warp per SM, with the
// working set (Vzz, A, M = Vzz A, Qzz, B, B^T Vzz, Quz, K, K^T Quu: ~1.5k
// values) in thread-local memory cached in L1 / L2.
#include "lane_algebra.cuh"

namespace laf {

template <typename T>
__global__ void __launch_bounds__(BLOCK)
riccati_unfused_kernel(const Consts c, const int H, const int B,
                       const T* __restrict__ A_p, const T* __restrict__ B_p,
                       const T* __restrict__ lz_p, const T* __restrict__ lu_p,
                       const T* __restrict__ lzz_p, const T* __restrict__ luz_p,
                       const T* __restrict__ luu_p, const T* __restrict__ U_p,
                       const T* __restrict__ ZU_p, const T* __restrict__ phiz_p,
                       const T* __restrict__ phizz_p, const T* __restrict__ reg_p,
                       T* __restrict__ kk_out, T* __restrict__ KK_out,
                       T* __restrict__ dV1_out, T* __restrict__ dV2_out,
                       T* __restrict__ fail_out, T* __restrict__ pg_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;

  // bounds folded in double, as the JAX kernel folds host floats
  const T lb = T(c.lb), ub = T(c.ub);
  const T lo_g = T(c.lb + 1e-7 * (c.ub - c.lb)), hi_g = T(c.ub - 1e-7 * (c.ub - c.lb));
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
  T Ak[NZ][NZ], Bk[NZ][NU], M[NZ][NZ], Qzz[NZ][NZ], BtV[NU][NZ], Quz[NU][NZ], K[NU][NZ],
      KtQuu[NZ][NU];

#pragma unroll 1
  for (int jstep = 0; jstep < H; ++jstep) {
    const int k = H - 1 - jstep;
    const size_t kz = (size_t)k * NZ, ku = (size_t)k * NU;
#pragma unroll 1
    for (int i = 0; i < NZ; ++i) {
      for (int j = 0; j < NZ; ++j) Ak[i][j] = A_p[((kz + i) * NZ + j) * sB + b];
      for (int j = 0; j < NU; ++j) Bk[i][j] = B_p[((kz + i) * NU + j) * sB + b];
    }
    T lz[NZ], lu[NU], u[NU];
    for (int i = 0; i < NZ; ++i) lz[i] = lz_p[(kz + i) * sB + b];
    for (int i = 0; i < NU; ++i) {
      lu[i] = lu_p[(ku + i) * sB + b];
      u[i] = U_p[(ku + i) * sB + b];
    }

    // ---- adjoint for the true projected gradient ----
    T pg_step = T(0);
    for (int j = 0; j < NU; ++j) {
      T gu = lu[j];
      for (int r = 0; r < NZ; ++r) gu += Bk[r][j] * lam[r];
      const bool at_lo = (u[j] <= lo_g) && (gu > T(0));
      const bool at_hi = (u[j] >= hi_g) && (gu < T(0));
      const T agu = fabs(gu) * ((at_lo || at_hi) ? T(0) : T(1));
      pg_step = j == 0 ? agu : nmax(pg_step, agu);
    }
    pg = nmax(pg, pg_step);
    T lam_n[NZ];
    for (int a = 0; a < NZ; ++a) {
      T acc = lz[a];
      for (int r = 0; r < NZ; ++r) acc += Ak[r][a] * lam[r];
      lam_n[a] = acc;
    }
    for (int a = 0; a < NZ; ++a) lam[a] = lam_n[a];

    // ---- Q expansions ----
    T Qz[NZ], Qu[NU];
    for (int a = 0; a < NZ; ++a) {
      T acc = lz[a];
      for (int r = 0; r < NZ; ++r) acc += Ak[r][a] * Vz[r];
      Qz[a] = acc;
    }
    for (int j = 0; j < NU; ++j) {
      T acc = lu[j];
      for (int r = 0; r < NZ; ++r) acc += Bk[r][j] * Vz[r];
      Qu[j] = acc;
    }
    // M = Vzz A; Qzz = lzz + A^T M
#pragma unroll 1
    for (int i = 0; i < NZ; ++i)
      for (int cc = 0; cc < NZ; ++cc) {
        T acc = T(0);
        for (int r = 0; r < NZ; ++r) acc += Vzz[i][r] * Ak[r][cc];
        M[i][cc] = acc;
      }
#pragma unroll 1
    for (int a = 0; a < NZ; ++a)
      for (int cc = 0; cc < NZ; ++cc) {
        T acc = T(0);
        for (int i = 0; i < NZ; ++i) acc += Ak[i][a] * M[i][cc];
        Qzz[a][cc] = lzz_p[((kz + a) * NZ + cc) * sB + b] + acc;
      }
    // B^T Vzz; Quz = luz + (B^T Vzz) A; Quu = luu + (B^T Vzz) B
#pragma unroll 1
    for (int j = 0; j < NU; ++j)
      for (int cc = 0; cc < NZ; ++cc) {
        T acc = T(0);
        for (int r = 0; r < NZ; ++r) acc += Bk[r][j] * Vzz[r][cc];
        BtV[j][cc] = acc;
      }
    T Quu[NU][NU];
    for (int j = 0; j < NU; ++j) {
#pragma unroll 1
      for (int cc = 0; cc < NZ; ++cc) {
        T acc = T(0);
        for (int r = 0; r < NZ; ++r) acc += BtV[j][r] * Ak[r][cc];
        Quz[j][cc] = luz_p[((ku + j) * NZ + cc) * sB + b] + acc;
      }
      for (int jj = 0; jj < NU; ++jj) {
        T acc = T(0);
        for (int r = 0; r < NZ; ++r) acc += BtV[j][r] * Bk[r][jj];
        Quu[j][jj] = luu_p[((ku + j) * NU + jj) * sB + b] + acc;
      }
    }

    // ---- DDP second-order term with the pre-update Vz ----
    if (c.use_ddp) {
      const T* zu = ZU_p + (size_t)k * NZU * sB + b;
      const T q[4] = {zu[6 * sB], zu[7 * sB], zu[8 * sB], zu[9 * sB]};
      const T usum = zu[NZ * sB] + zu[(NZ + 1) * sB] + zu[(NZ + 2) * sB] + zu[(NZ + 3) * sB];
      add_ddp_term(c, q, usum, Vz, Qzz, Quz);
    }

    // ---- Tassa regularization through B^T B and B^T A ----
    T Quu_r[NU][NU];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) {
        T bb = T(0);
        for (int r = 0; r < NZ; ++r) bb += Bk[r][i] * Bk[r][j];
        Quu_r[i][j] = Quu[i][j] + reg * bb;
      }
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
      for (int j = 0; j < NU; ++j) {
        T bta = T(0);
        for (int r = 0; r < NZ; ++r) bta += Bk[r][j] * Ak[r][cc];
        rhs[j] = (Quz[j][cc] + reg * bta) * fr[j];
      }
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

    for (int i = 0; i < NU; ++i) kk_out[(ku + i) * sB + b] = kf[i];
#pragma unroll 1
    for (int i = 0; i < NU; ++i)
      for (int cc = 0; cc < NZ; ++cc) KK_out[((ku + i) * NZ + cc) * sB + b] = K[i][cc];
  }
  dV1_out[b] = dv1;
  dV2_out[b] = dv2;
  fail_out[b] = fail;
  pg_out[b] = pg;
}

template <typename T>
int launch_riccati_unfused(const Consts* c, int H, int B, const T* A, const T* Bm, const T* lz,
                           const T* lu, const T* lzz, const T* luz, const T* luu, const T* U,
                           const T* ZU, const T* phiz, const T* phizz, const T* reg, T* kk,
                           T* KK, T* dV1, T* dV2, T* fail, T* pg, cudaStream_t stream) {
  if (B == 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  riccati_unfused_kernel<T><<<grid, BLOCK, 0, stream>>>(*c, H, B, A, Bm, lz, lu, lzz, luz, luu,
                                                        U, ZU, phiz, phizz, reg, kk, KK, dV1,
                                                        dV2, fail, pg);
  return (int)cudaGetLastError();
}

}  // namespace laf

extern "C" {

int laf_riccati_unfused_f32(const laf::Consts* c, int H, int B, const float* A, const float* Bm,
                            const float* lz, const float* lu, const float* lzz,
                            const float* luz, const float* luu, const float* U,
                            const float* ZU, const float* phiz, const float* phizz,
                            const float* reg, float* kk, float* KK, float* dV1, float* dV2,
                            float* fail, float* pg, cudaStream_t stream) {
  return laf::launch_riccati_unfused<float>(c, H, B, A, Bm, lz, lu, lzz, luz, luu, U, ZU, phiz,
                                            phizz, reg, kk, KK, dV1, dV2, fail, pg, stream);
}

int laf_riccati_unfused_f64(const laf::Consts* c, int H, int B, const double* A,
                            const double* Bm, const double* lz, const double* lu,
                            const double* lzz, const double* luz, const double* luu,
                            const double* U, const double* ZU, const double* phiz,
                            const double* phizz, const double* reg, double* kk, double* KK,
                            double* dV1, double* dV2, double* fail, double* pg,
                            cudaStream_t stream) {
  return laf::launch_riccati_unfused<double>(c, H, B, A, Bm, lz, lu, lzz, luz, luu, U, ZU, phiz,
                                             phizz, reg, kk, KK, dV1, dV2, fail, pg, stream);
}

}  // extern "C"
