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
// Bound on the H100.  Per scenario and step it reads 763 values (A 289, lzz
// 289, B 68, luz 68, lz 17, luu 16, lu 4, U 4, and of ZU's 21 only the DDP
// term's rows 6..9 and 17..20) and writes 72 (kk, KK): 345 MB in f32 at
// H=50, B=2048, or 0.10 ms at 3.35 TB/s.  Its
// arithmetic, about 35.6k flops per scenario and step (chip_smoke.py
// K3_FLOPS), takes 0.05 ms at the 67 TFLOP/s f32 rate: bound by bytes.
//
// None of the streamed values depends on the recursion, and a scenario's
// working set (~1k values) is too large for one thread.  So:
//  - A block takes K3_SCEN = 8 consecutive scenarios.  Step k's tile of
//    them (K3_ROWS = 763 rows of 8 values: all but ZU's unread rows; one row
//    is one 32-byte sector in f32) comes into a K3_STAGES = 2 ring in dynamic
//    shared memory with cp.async, one step ahead of the recursion, in
//    16-byte copies where B and the pointers allow, else one value a copy;
//    a thread copies whole rows, from pointers set up before the time loop.
//  - Thread t is worker cc = t / 8 of scenario s = t % 8: the K3_COLS = 24
//    workers of a scenario lie in 6 warps, and a warp holds 4 workers of all
//    8 scenarios.  The tile and the working set are stored entry-major,
//    scenario-minor ([entry][8]), so a warp's 32 lanes read 32 neighbouring
//    words where they read one entry of 4 columns (A[r][cc], Vzz[r][cc]), a
//    broadcast of 8 words where they read one entry for every column
//    (A[i][a], Vzz[i][r]), and 32 banks where they read a row of 4 columns
//    (V[cc][a], 17 x 8 words apart): no access has a bank conflict in f32.
//  - Workers cc < 17 compute column cc of every 17-wide product, and read
//    A, lzz, B, luz and luu in place in the ring: M = Vzz A (its column in
//    registers), Qzz = lzz + A^T M, B^T Vzz, Quz, the DDP term (the column
//    form of add_ddp_term), the K solve, entry cc of Vz and lam, K^T Quu,
//    and column cc of the new Vzz; workers 17..20 form Qu and the adjoint
//    gradient, workers 0..15 the 16 entries of Quu and of Quu + reg B^T B.
//  - The scalar chain (projected-gradient max, the Quu symmetrisation, the
//    boxQP, masked4 and chol4, the fail flag, dV1, dV2) runs on worker 23
//    of each scenario: 8 lanes of warp 5, one per scenario, so that a warp
//    instruction there serves 8 scenarios; meanwhile the column workers
//    form B^T A.  Its inputs and outputs (kf, the
//    free mask, the factor) pass through shared memory between barriers.
//  - Each entry is computed by one thread with the expression of the
//    one-thread kernel this design replaced; the symmetric Vzz entry
//    0.5 (v_ab + v_ba) takes v_ba from column a's worker, so each product
//    is formed once and Vzz stays exactly symmetric.
// Shared memory: 2 stages of 763 x 8 values and a 950 x 8 working set,
// 79,232 B a block in f32 (2 blocks of 6 warps an SM: B=2048 is one wave of
// 256 blocks) and 158,464 B in f64 (1 block an SM).  Of a block's 6 warps,
// 5 carry the column work; with warps dealt to an SM's 4 schedulers by warp
// index, 2 blocks put 3, 3, 2 and 2 such warps on them (32 workers a
// scenario, 8 warps a block, would put 4, 2, 2, 2), and every block barrier
// waits on 6 warps, not 8.
#include "lane_algebra.cuh"

namespace laf {

constexpr int K3_SCEN = 8;                       // scenarios per block
constexpr int K3_COLS = 24;                      // workers per scenario
constexpr int K3_THREADS = K3_SCEN * K3_COLS;
constexpr int K3_STAGES = 2;                     // ring depth
constexpr int K3_SCALAR = K3_COLS - 1;           // the worker of the scalar chain
// rows of a step's tile: A (r*17 + c), lzz, B (r*4 + j), luz (j*17 + c), lz,
// luu (j*4 + jj), lu, U, ZU rows 6..9 (the quaternion) and 17..20 (u)
constexpr int T_A = 0, T_LZZ = T_A + NZ * NZ, T_B = T_LZZ + NZ * NZ, T_LUZ = T_B + NZ * NU,
              T_LZ = T_LUZ + NU * NZ, T_LUU = T_LZ + NZ, T_LU = T_LUU + NU * NU, T_U = T_LU + NU,
              T_Q = T_U + NU, T_ZUU = T_Q + 4, K3_ROWS = T_ZUU + NU;
// entries of a scenario's working set: Vzz, V (Qzz, then the unsymmetrised
// new Vzz), B^T Vzz, K, Quz and K^T Quu (as 4 rows of 17), Vz, lam, Quu,
// Quu + reg B^T B, Qu, the adjoint gradient gu, kf, the free mask, Quu kf,
// and the 14 entries of the factor
constexpr int W_VZZ = 0, W_V = W_VZZ + NZ * NZ, W_BTV = W_V + NZ * NZ, W_K = W_BTV + NU * NZ,
              W_QUZ = W_K + NU * NZ, W_KQ = W_QUZ + NU * NZ, W_VZ = W_KQ + NU * NZ,
              W_LAM = W_VZ + NZ, W_QUU = W_LAM + NZ, W_QUUR = W_QUU + NU * NU,
              W_QU = W_QUUR + NU * NU, W_GU = W_QU + NU, W_KF = W_GU + NU, W_FR = W_KF + NU,
              W_QKF = W_FR + NU, W_L = W_QKF + NU, K3_WORK = W_L + 14;

template <typename T>
constexpr int k3_smem_bytes() {
  return (K3_STAGES * K3_ROWS + K3_WORK) * K3_SCEN * (int)sizeof(T);
}

// Blocks per SM the kernel is built for: in f32 the 2 its shared memory
// allows (at most 170 registers a thread); the f64 kernel, off the timed
// paths, runs 1.
template <typename T>
constexpr int k3_min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

// VW: values per copy, 16 bytes' worth, or 1 where 16-byte copies are not aligned
template <typename T, int VW>
__global__ void __launch_bounds__(K3_THREADS, k3_min_blocks<T>())
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
  extern __shared__ __align__(16) unsigned char k3_smem[];
  T* ring = reinterpret_cast<T*>(k3_smem);          // [K3_STAGES][K3_ROWS][K3_SCEN]
  T* const w = ring + K3_STAGES * K3_ROWS * K3_SCEN;  // [K3_WORK][K3_SCEN]
  const int tid = threadIdx.x;
  const int s = tid % K3_SCEN, cc = tid / K3_SCEN;  // scenario in the block, worker
  const int b0 = blockIdx.x * K3_SCEN;
  const int nb = min(K3_SCEN, B - b0);
  // the workers of a missing scenario (the ragged edge) take part in every
  // barrier and compute on what their ring slots hold, and store nothing
  const bool live = s < nb;
  const int b = b0 + (live ? s : 0);
  const size_t sB = (size_t)B;
  const bool col = cc < NZ;
  auto W = [&](int e) -> T& { return w[e * K3_SCEN + s]; };  // this scenario's entry e

  // The tile's rows are K3_SCEN neighbouring values of one tensor each:
  // thread t copies rows t, t + K3_THREADS, ..., from pointers fixed here
  // and moved by the tensor's step stride, in copies of VW values.
  constexpr int RPT = (K3_ROWS + K3_THREADS - 1) / K3_THREADS;
  const int cpr = (nb + VW - 1) / VW;  // copies per row (VW divides nb where VW > 1)
  const T* rsrc[RPT];
  size_t rstride[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = min(tid + i * K3_THREADS, K3_ROWS - 1);
    rsrc[i] = (r < T_LZZ   ? A_p + (size_t)r * sB
               : r < T_B   ? lzz_p + (size_t)(r - T_LZZ) * sB
               : r < T_LUZ ? B_p + (size_t)(r - T_B) * sB
               : r < T_LZ  ? luz_p + (size_t)(r - T_LUZ) * sB
               : r < T_LUU ? lz_p + (size_t)(r - T_LZ) * sB
               : r < T_LU  ? luu_p + (size_t)(r - T_LUU) * sB
               : r < T_U   ? lu_p + (size_t)(r - T_LU) * sB
               : r < T_Q   ? U_p + (size_t)(r - T_U) * sB
               : r < T_ZUU ? ZU_p + (size_t)(6 + r - T_Q) * sB
                           : ZU_p + (size_t)(NZ + r - T_ZUU) * sB) + b0;
    rstride[i] = (size_t)(r < T_B ? NZ * NZ : r < T_LZ ? NU * NZ : r < T_LUU ? NZ
                          : r < T_LU ? NU * NU : r < T_Q ? NU : NZU) * sB;
  }
  // the tile of the j-th step of the sweep (step H-1-j) into its ring stage;
  // one group per call, empty past H
  auto fetch = [&](int j) {
    if (j < H) {
      const int k = H - 1 - j;
      T* stage = ring + (size_t)(j % K3_STAGES) * K3_ROWS * K3_SCEN;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tid + i * K3_THREADS;
        if (r < K3_ROWS) {
          const T* src = rsrc[i] + (size_t)k * rstride[i];
          T* dst = stage + r * K3_SCEN;
#pragma unroll
          for (int q = 0; q < K3_SCEN / VW; ++q)
            if (q < cpr) cp_async<VW * (int)sizeof(T)>(dst + q * VW, src + q * VW);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < K3_STAGES; ++j) fetch(j);

  // bounds folded in double, as the JAX kernel folds host floats
  const T lb = T(c.lb), ub = T(c.ub);
  const T lo_g = T(c.lb + 1e-7 * (c.ub - c.lb)), hi_g = T(c.ub - 1e-7 * (c.ub - c.lb));
  const T reg = reg_p[b];

  // ---- carries, in shared memory ----
  for (int e = cc; e < NZ * NZ; e += K3_COLS) W(W_VZZ + e) = phizz_p[e * sB + b];
  if (col) {
    const T v = phiz_p[cc * sB + b];
    W(W_VZ + cc) = v;
    W(W_LAM + cc) = v;
  }
  T dv1 = T(0), dv2 = T(0), fail = T(0), pg = T(0);  // the scalar worker's

#pragma unroll 1
  for (int jstep = 0; jstep < H; ++jstep) {
    const int k = H - 1 - jstep;
    const size_t ku = (size_t)k * NU;
    const T* st = ring + (size_t)(jstep % K3_STAGES) * K3_ROWS * K3_SCEN + s;
    auto R = [&](int r) -> T { return st[r * K3_SCEN]; };  // row r of the tile
    cp_async_wait<K3_STAGES - 1>();  // this step's group has landed (this thread's copies)
    __syncthreads();                 // ... and every thread's; the last step's Vzz

    // ---- 1: adjoint and Q expansions; M = Vzz A, Qzz = lzz + A^T M, B^T Vzz ----
    T Qz = T(0), lam_new = T(0);
    if (col) {
      T acol[NZ];
      lam_new = R(T_LZ + cc);
      T qz = lam_new;
#pragma unroll
      for (int r = 0; r < NZ; ++r) {
        acol[r] = R(T_A + r * NZ + cc);
        lam_new += acol[r] * W(W_LAM + r);
        qz += acol[r] * W(W_VZ + r);
      }
      Qz = qz;
      T m[NZ];
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < NZ; ++r) acc += W(W_VZZ + i * NZ + r) * acol[r];
        m[i] = acc;
      }
#pragma unroll
      for (int a = 0; a < NZ; ++a) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < NZ; ++i) acc += R(T_A + i * NZ + a) * m[i];
        W(W_V + a * NZ + cc) = R(T_LZZ + a * NZ + cc) + acc;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < NZ; ++r) acc += R(T_B + r * NU + j) * W(W_VZZ + r * NZ + cc);
        W(W_BTV + j * NZ + cc) = acc;
      }
    } else if (cc < NZ + NU) {  // workers 17..20: Qu and the adjoint gradient gu
      const int j = cc - NZ;
      T gu = R(T_LU + j), qu = gu;
#pragma unroll
      for (int r = 0; r < NZ; ++r) {
        const T bj = R(T_B + r * NU + j);
        gu += bj * W(W_LAM + r);
        qu += bj * W(W_VZ + r);
      }
      W(W_GU + j) = gu;
      W(W_QU + j) = qu;
    }
    __syncthreads();  // (1): every column of B^T Vzz; every read of lam done

    // ---- 2: Quz (+ the DDP term with the pre-update Vz), Quu ----
    if (col) {
      W(W_LAM + cc) = lam_new;
      T quz[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < NZ; ++r) acc += W(W_BTV + j * NZ + r) * R(T_A + r * NZ + cc);
        quz[j] = R(T_LUZ + j * NZ + cc) + acc;
      }
      if (c.use_ddp && cc >= 6 && cc < NX) {  // the columns the term touches
        T vz[NZ], qzz[NZ];
#pragma unroll
        for (int r = 0; r < NZ; ++r) {
          vz[r] = W(W_VZ + r);
          qzz[r] = W(W_V + r * NZ + cc);
        }
        const T q[4] = {R(T_Q), R(T_Q + 1), R(T_Q + 2), R(T_Q + 3)};
        const T usum = R(T_ZUU) + R(T_ZUU + 1) + R(T_ZUU + 2) + R(T_ZUU + 3);
        add_ddp_term_col(c, q, usum, vz, cc, qzz, quz);
#pragma unroll
        for (int r = 0; r < NZ; ++r) W(W_V + r * NZ + cc) = qzz[r];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) W(W_QUZ + j * NZ + cc) = quz[j];
    }
    if (cc < NU * NU) {  // Quu = luu + (B^T Vzz) B and Quu + reg B^T B, entry (j, jj)
      const int j = cc >> 2, jj = cc & 3;
      T acc = T(0), bb = T(0);
#pragma unroll
      for (int r = 0; r < NZ; ++r) {
        const T bjj = R(T_B + r * NU + jj);
        acc += W(W_BTV + j * NZ + r) * bjj;
        bb += R(T_B + r * NU + j) * bjj;
      }
      const T quu = R(T_LUU + cc) + acc;
      W(W_QUU + cc) = quu;
      W(W_QUUR + cc) = quu + reg * bb;
    }
    __syncthreads();  // (2)

    // ---- 3: the scalar chain, one worker per scenario; meanwhile the
    // column workers form column cc of B^T A (the Tassa term of the K solve) ----
    T bta[NU];
    if (col) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < NZ; ++r) acc += R(T_B + r * NU + j) * R(T_A + r * NZ + cc);
        bta[j] = acc;
      }
    }
    if (cc == K3_SCALAR) {
      T Quu[NU][NU], Quu_r[NU][NU], Qu[NU], u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          Quu[i][j] = W(W_QUU + i * NU + j);
          Quu_r[i][j] = W(W_QUUR + i * NU + j);
        }
        Qu[i] = W(W_QU + i);
        u[i] = R(T_U + i);
      }
      T pg_step = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const T gu = W(W_GU + j);
        const bool at_lo = (u[j] <= lo_g) && (gu > T(0));
        const bool at_hi = (u[j] >= hi_g) && (gu < T(0));
        const T agu = fabs(gu) * ((at_lo || at_hi) ? T(0) : T(1));
        pg_step = j == 0 ? agu : nmax(pg_step, agu);
      }
      pg = nmax(pg, pg_step);
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = i; j < NU; ++j) {
          const T sym = T(0.5) * (Quu_r[i][j] + Quu_r[j][i]);
          Quu_r[i][j] = sym;
          Quu_r[j][i] = sym;
        }
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
      fail = nmax(fail, L4.ok ? T(0) : T(1));
      T Quu_kf[NU];
      mat_vec4(Quu, kf, Quu_kf);
      dv1 += kf[0] * Qu[0] + kf[1] * Qu[1] + kf[2] * Qu[2] + kf[3] * Qu[3];
      dv2 += T(0.5) * (kf[0] * Quu_kf[0] + kf[1] * Quu_kf[1] + kf[2] * Quu_kf[2] + kf[3] * Quu_kf[3]);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        W(W_KF + i) = kf[i];
        W(W_FR + i) = fr[i];
        W(W_QKF + i) = Quu_kf[i];
        if (live) kk_out[(ku + i) * sB + b] = kf[i];
      }
      const T l[14] = {L4.l00, L4.l10, L4.l20, L4.l30, L4.l11, L4.l21, L4.l31,
                       L4.l22, L4.l32, L4.l33, L4.r00, L4.r11, L4.r22, L4.r33};
#pragma unroll
      for (int i = 0; i < 14; ++i) W(W_L + i) = l[i];
    }
    __syncthreads();  // (3)

    // ---- 4: column cc of K, entry cc of Vz, row cc of K^T Quu ----
    if (col) {
      Chol4<T> L4;
      L4.l00 = W(W_L + 0), L4.l10 = W(W_L + 1), L4.l20 = W(W_L + 2), L4.l30 = W(W_L + 3);
      L4.l11 = W(W_L + 4), L4.l21 = W(W_L + 5), L4.l31 = W(W_L + 6);
      L4.l22 = W(W_L + 7), L4.l32 = W(W_L + 8), L4.l33 = W(W_L + 9);
      L4.r00 = W(W_L + 10), L4.r11 = W(W_L + 11), L4.r22 = W(W_L + 12), L4.r33 = W(W_L + 13);
      L4.ok = true;
      T kf[NU], fr[NU], Qu[NU], Quu_kf[NU], quz[NU], rhs[NU], x[NU], Kc[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        kf[j] = W(W_KF + j);
        fr[j] = W(W_FR + j);
        Qu[j] = W(W_QU + j);
        Quu_kf[j] = W(W_QKF + j);
        quz[j] = W(W_QUZ + j * NZ + cc);
        rhs[j] = (quz[j] + reg * bta[j]) * fr[j];
      }
      chol4_solve(L4, rhs, x);
#pragma unroll
      for (int j = 0; j < NU; ++j) Kc[j] = -x[j] * fr[j];
      const T KtQuuk = Kc[0] * Quu_kf[0] + Kc[1] * Quu_kf[1] + Kc[2] * Quu_kf[2] + Kc[3] * Quu_kf[3];
      const T KtQu = Kc[0] * Qu[0] + Kc[1] * Qu[1] + Kc[2] * Qu[2] + Kc[3] * Qu[3];
      const T QuzTkf = quz[0] * kf[0] + quz[1] * kf[1] + quz[2] * kf[2] + quz[3] * kf[3];
      W(W_VZ + cc) = Qz + KtQuuk + KtQu + QuzTkf;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        W(W_K + j * NZ + cc) = Kc[j];
        W(W_KQ + j * NZ + cc) = Kc[0] * W(W_QUU + j) + Kc[1] * W(W_QUU + NU + j) +
                                Kc[2] * W(W_QUU + 2 * NU + j) + Kc[3] * W(W_QUU + 3 * NU + j);
        if (live) KK_out[((ku + j) * NZ + cc) * sB + b] = Kc[j];
      }
    }
    __syncthreads();  // (4): K, Quz, K^T Quu complete; the stage is read for the last time above
    fetch(jstep + K3_STAGES);

    // ---- 5: V <- Qzz + K^T Quu K + K^T Quz + Quz^T K, column cc; then
    // Vzz = 0.5 (V + V^T), column cc (v_ba is the entry column a's worker wrote) ----
    if (col) {
      T Kc[NU], quz[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        Kc[j] = W(W_K + j * NZ + cc);
        quz[j] = W(W_QUZ + j * NZ + cc);
      }
#pragma unroll
      for (int a = 0; a < NZ; ++a) {
        T Ka[NU], Qa[NU], KQa[NU];
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          Ka[j] = W(W_K + j * NZ + a);
          Qa[j] = W(W_QUZ + j * NZ + a);
          KQa[j] = W(W_KQ + j * NZ + a);
        }
        const T kqk_ab = KQa[0] * Kc[0] + KQa[1] * Kc[1] + KQa[2] * Kc[2] + KQa[3] * Kc[3];
        const T kqz_ab = Ka[0] * quz[0] + Ka[1] * quz[1] + Ka[2] * quz[2] + Ka[3] * quz[3];
        const T kqz_ba = Kc[0] * Qa[0] + Kc[1] * Qa[1] + Kc[2] * Qa[2] + Kc[3] * Qa[3];
        T& v = W(W_V + a * NZ + cc);
        v = v + kqk_ab + kqz_ab + kqz_ba;
      }
    }
    __syncthreads();  // (5)
    if (col) {
#pragma unroll
      for (int a = 0; a < NZ; ++a)
        W(W_VZZ + a * NZ + cc) = T(0.5) * (W(W_V + a * NZ + cc) + W(W_V + cc * NZ + a));
    }
  }
  if (cc == K3_SCALAR && live) {
    dV1_out[b] = dv1;
    dV2_out[b] = dv2;
    fail_out[b] = fail;
    pg_out[b] = pg;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, int VW>
int launch_riccati_unfused_vw(const Consts* c, int H, int B, const T* A, const T* Bm,
                              const T* lz, const T* lu, const T* lzz, const T* luz, const T* luu,
                              const T* U, const T* ZU, const T* phiz, const T* phizz,
                              const T* reg, T* kk, T* KK, T* dV1, T* dV2, T* fail, T* pg,
                              cudaStream_t stream) {
  constexpr int bytes = k3_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(riccati_unfused_kernel<T, VW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + K3_SCEN - 1) / K3_SCEN;
  riccati_unfused_kernel<T, VW><<<grid, K3_THREADS, bytes, stream>>>(
      *c, H, B, A, Bm, lz, lu, lzz, luz, luu, U, ZU, phiz, phizz, reg, kk, KK, dV1, dV2, fail, pg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_riccati_unfused(const Consts* c, int H, int B, const T* A, const T* Bm, const T* lz,
                           const T* lu, const T* lzz, const T* luz, const T* luu, const T* U,
                           const T* ZU, const T* phiz, const T* phizz, const T* reg, T* kk,
                           T* KK, T* dV1, T* dV2, T* fail, T* pg, cudaStream_t stream) {
  if (B == 0) return 0;
  constexpr int VW = 16 / (int)sizeof(T);
  // 16-byte copies need every streamed row to start on 16 bytes
  const size_t ptrs = reinterpret_cast<size_t>(A) | reinterpret_cast<size_t>(Bm) |
                      reinterpret_cast<size_t>(lz) | reinterpret_cast<size_t>(lu) |
                      reinterpret_cast<size_t>(lzz) | reinterpret_cast<size_t>(luz) |
                      reinterpret_cast<size_t>(luu) | reinterpret_cast<size_t>(U) |
                      reinterpret_cast<size_t>(ZU);
  const bool aligned = B % VW == 0 && ptrs % 16 == 0;
  return aligned ? launch_riccati_unfused_vw<T, VW>(c, H, B, A, Bm, lz, lu, lzz, luz, luu, U, ZU,
                                                    phiz, phizz, reg, kk, KK, dV1, dV2, fail, pg,
                                                    stream)
                 : launch_riccati_unfused_vw<T, 1>(c, H, B, A, Bm, lz, lu, lzz, luz, luu, U, ZU,
                                                   phiz, phizz, reg, kk, KK, dV1, dV2, fail, pg,
                                                   stream);
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

// Bytes of K3's dynamic shared memory per block (the ring and the working set).
int laf_riccati_unfused_smem_bytes(int f64) {
  return f64 ? laf::k3_smem_bytes<double>() : laf::k3_smem_bytes<float>();
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
