// K1: fused closed-loop rollout with stage and terminal cost.
//
// Replaces learningagileflight_se3_tpu/ops/rollout_pallas.py
// rollout_forward_pallas (kernel _make_kernel).  Plain PyTorch version:
// ops/rollout.py rollout_forward_plain.
//
// Bound on the H100.  Per scenario and step it reads 94 values (Zr 17, Ur 4,
// kk 4, KK 68, t_w 1) and writes 21 (Zn 17, Un 4), plus 12 per scenario
// once: B (115 H + 12) values, 47.2 MB in f32 at H=50, B=2048, or 14 us at
// 3.35 TB/s.  Its arithmetic, about 420 flops per scenario and step, takes
// under 1 us: bound by bytes, about 14 us.
//
// Layout time-major, batch-last: entry (j, i, b) of an (H, n, B) tensor is
// at (j*n + i)*B + b.  The gains do not depend on the state, so they can be
// fetched ahead of the recursion:
//  - A block takes K1_SCEN = 16 scenarios (B=2048 spreads over 128 SMs),
//    four threads a scenario, one per control row u[i]: the threads of a
//    scenario are four neighbouring lanes, which combine their u[i] with
//    __shfl_sync and then run the clip, the stage cost and the Euler step
//    redundantly, so each holds the whole state.
//  - The step's tile of the block's scenarios (94 rows of 16 values, 6 KB in
//    f32, 12 KB in f64) comes into a ring of K1_STAGES = 8 stages in shared
//    memory with cp.async, K1_STAGES - 1 steps ahead of the recursion, in
//    16-byte copies (one value a copy where B or a pointer does not allow
//    16-byte alignment); a thread copies whole rows, from pointers set up
//    before the time loop.  About 6 MB are in flight across the card, and the
//    chain of dependent work per step is the state update alone.
//  - Zn and Un are written by the thread of the control row r % 4: a warp's
//    store of one row covers eight neighbouring scenarios, one 32-byte
//    sector in f32.
#include "lane_algebra.cuh"

namespace laf {

constexpr int K1_SCEN = 16;               // scenarios per block
constexpr int K1_THREADS = K1_SCEN * NU;  // one thread per control row
constexpr int K1_STAGES = 8;              // ring depth
// rows of a step's tile: Zr, Ur, kk, KK (i*17 + r), t_w
constexpr int R_UR = NZ, R_KK = NZ + NU, R_GAIN = NZ + 2 * NU, R_TW = R_GAIN + NU * NZ;
constexpr int K1_ROWS = R_TW + 1;

template <typename T>
constexpr int k1_smem_bytes() {
  return K1_STAGES * K1_ROWS * K1_SCEN * (int)sizeof(T);
}

// VW: values per copy, 16 bytes' worth, or 1 where 16-byte copies are not aligned
template <typename T, int VW>
__global__ void __launch_bounds__(K1_THREADS)
rollout_kernel(const Consts c, const int H, const int B,
               const T* __restrict__ Zr, const T* __restrict__ Ur,
               const T* __restrict__ kk, const T* __restrict__ KK,
               const T* __restrict__ tw, const T* __restrict__ alpha_p,
               const T* __restrict__ goal_p, const T* __restrict__ tp_p,
               const T* __restrict__ tq_p,
               T* __restrict__ Zn, T* __restrict__ Un, T* __restrict__ cost_p) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* ring = reinterpret_cast<T*>(k1_smem);  // [K1_STAGES][K1_ROWS][K1_SCEN]
  const int tid = threadIdx.x;
  const int sc = tid >> 2, row = tid & 3;  // scenario in the block, control row
  const int b0 = blockIdx.x * K1_SCEN;
  const int nb = min(K1_SCEN, B - b0);
  // threads of a missing scenario (the ragged edge) copy, shuffle and
  // compute on scenario b0's data like the others, and store nothing
  const bool live = sc < nb;
  const int b = b0 + (live ? sc : 0);
  const size_t sB = (size_t)B;

  // The tile's rows are 16 neighbouring values of one (H, n, B) tensor each:
  // thread t copies rows t and t + K1_THREADS, from pointers fixed here and
  // advanced by the tensor's step stride, in copies of VW values.
  const int cpr = (nb + VW - 1) / VW;  // copies per row (VW divides nb where VW > 1)
  const T* rsrc[2];
  size_t rstride[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = min(tid + i * K1_THREADS, K1_ROWS - 1);
    rsrc[i] = (r < R_UR     ? Zr + (size_t)r * sB
               : r < R_KK   ? Ur + (size_t)(r - R_UR) * sB
               : r < R_GAIN ? kk + (size_t)(r - R_KK) * sB
               : r < R_TW   ? KK + (size_t)(r - R_GAIN) * sB
                            : tw) + b0;
    rstride[i] = (r < R_UR ? NZ : r < R_GAIN ? NU : r < R_TW ? NU * NZ : 1) * sB;
  }
  // step j's tile into its ring stage; one group per call, empty past H
  auto fetch = [&](int j) {
    if (j < H) {
      T* stage = ring + (size_t)(j % K1_STAGES) * K1_ROWS * K1_SCEN;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = tid + i * K1_THREADS;
        if (r < K1_ROWS) {
          const T* src = rsrc[i] + j * rstride[i];
          T* dst = stage + r * K1_SCEN;
#pragma unroll
          for (int q = 0; q < K1_SCEN / VW; ++q)
            if (q < cpr) cp_async<VW * (int)sizeof(T)>(dst + q * VW, src + q * VW);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < K1_STAGES - 1; ++j) fetch(j);

  const T dt = T(c.dt), lb = T(c.lb), ub = T(c.ub), m = T(c.mass), g = T(c.g);
  const T Jx = T(c.Jx), Jy = T(c.Jy), Jz = T(c.Jz);
  const T l2 = T(c.l / 2.0), cq = T(c.c);
  const T wrt = T(c.wrt), wqt = T(c.wqt), wthrust = T(c.wthrust), wrf = T(c.wrf);
  const T wvf = T(c.wvf), wqf = T(c.wqf), wwf = T(c.wwf), w_du = T(c.w_du);
  const T w_bound = T(c.w_bound), wbw = T(c.w_bound_weight);
  const T ident[4] = {T(1), T(0), T(0), T(0)};

  T goal[3], tp[3], tq[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    goal[i] = goal_p[i * sB + b];
    tp[i] = tp_p[i * sB + b];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tq[i] = tq_p[i * sB + b];
  const T alpha = alpha_p[b];

  T z[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = Zr[i * sB + b];
  T cost = T(0);
  const int lane0 = (tid & 31) & ~3;  // this scenario's first lane

#pragma unroll 1
  for (int j = 0; j < H; ++j) {
    cp_async_wait<K1_STAGES - 2>();  // step j's group has landed (this thread's copies)
    __syncthreads();                 // ... and every thread's; step j-1's stage is free
    fetch(j + K1_STAGES - 1);
    const T* st = ring + (size_t)(j % K1_STAGES) * K1_ROWS * K1_SCEN + sc;  // row r at st[r*K1_SCEN]

    // ---- u[row] = clip(u_ref + alpha k + K (z - z_ref)), then all four ----
    T dz[NZ];
#pragma unroll
    for (int r = 0; r < NZ; ++r) dz[r] = z[r] - st[r * K1_SCEN];
    T ui = st[(R_UR + row) * K1_SCEN] + alpha * st[(R_KK + row) * K1_SCEN];
    const T* Ki = st + (R_GAIN + row * NZ) * K1_SCEN;
#pragma unroll
    for (int r = 0; r < NZ; ++r) ui += Ki[r * K1_SCEN] * dz[r];
    ui = nclip(ui, lb, ub);
    T u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = __shfl_sync(0xffffffffu, ui, lane0 + i);

    // ---- stage cost at (z, u) ----
    const T* x = z;
    const T* up = z + NX;
    const T* q = z + 6;
    T cst = wrf * ((x[0] - goal[0]) * (x[0] - goal[0]) + (x[1] - goal[1]) * (x[1] - goal[1]) +
                   (x[2] - goal[2]) * (x[2] - goal[2]));
    cst += wvf * (x[3] * x[3] + x[4] * x[4] + x[5] * x[5]);
    cst += wwf * (x[10] * x[10] + x[11] * x[11] + x[12] * x[12]);
    if (c.use_wqf) cst += wqf * attitude_error(q, ident);
    T att = attitude_error(q, tq);
    T att_term = c.squared_attitude ? att * att : att;
    T tra = wrt * ((x[0] - tp[0]) * (x[0] - tp[0]) + (x[1] - tp[1]) * (x[1] - tp[1]) +
                   (x[2] - tp[2]) * (x[2] - tp[2])) + wqt * att_term;
    cst += st[R_TW * K1_SCEN] * tra;
    cst += wthrust * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + u[3] * u[3]);
    T du0 = u[0] - up[0], du1 = u[1] - up[1], du2 = u[2] - up[2], du3 = u[3] - up[3];
    cst += w_du * (du0 * du0 + du1 * du1 + du2 * du2 + du3 * du3);
    if (wbw > T(0)) {
      T v0 = nmax(fabs(x[10]) - w_bound, T(0));
      T v1 = nmax(fabs(x[11]) - w_bound, T(0));
      T v2 = nmax(fabs(x[12]) - w_bound, T(0));
      cst += wbw * (v0 * v0 + v1 * v1 + v2 * v2);
    }
    cost += cst;

    // ---- forward-Euler step, no quaternion renormalization ----
    const T Tm = (u[0] + u[1] + u[2] + u[3]) / m;
    const T w0 = q[0], x0 = q[1], y0 = q[2], z0 = q[3];
    const T ox = x[10], oy = x[11], oz = x[12];
    T xd[NX];
    xd[0] = x[3]; xd[1] = x[4]; xd[2] = x[5];
    xd[3] = 2 * (x0 * z0 + w0 * y0) * Tm;
    xd[4] = 2 * (y0 * z0 - w0 * x0) * Tm;
    xd[5] = (1 - 2 * (x0 * x0 + y0 * y0)) * Tm - g;
    xd[6] = T(0.5) * (-ox * x0 - oy * y0 - oz * z0);
    xd[7] = T(0.5) * (ox * w0 + oz * y0 - oy * z0);
    xd[8] = T(0.5) * (oy * w0 - oz * x0 + ox * z0);
    xd[9] = T(0.5) * (oz * w0 + oy * x0 - ox * y0);
    const T Mx = (-u[1] + u[3]) * l2;
    const T My = (-u[0] + u[2]) * l2;
    const T Mz = (u[0] - u[1] + u[2] - u[3]) * cq;
    const T cx = oy * (Jz * oz) - oz * (Jy * oy);
    const T cy = oz * (Jx * ox) - ox * (Jz * oz);
    const T cz = ox * (Jy * oy) - oy * (Jx * ox);
    xd[10] = (Mx - cx) / Jx;
    xd[11] = (My - cy) / Jy;
    xd[12] = (Mz - cz) / Jz;
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = x[i] + dt * xd[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) z[NX + i] = u[i];

    if (live) {
#pragma unroll
      for (int r = 0; r < NZ; ++r)
        if ((r & 3) == row) Zn[((size_t)j * NZ + r) * sB + b] = z[r];
      Un[((size_t)j * NU + row) * sB + b] = ui;
    }
  }

  // ---- terminal cost on the last state ----
  T cf = wrf * ((z[0] - goal[0]) * (z[0] - goal[0]) + (z[1] - goal[1]) * (z[1] - goal[1]) +
                (z[2] - goal[2]) * (z[2] - goal[2]));
  cf += wvf * (z[3] * z[3] + z[4] * z[4] + z[5] * z[5]);
  cf += wwf * (z[10] * z[10] + z[11] * z[11] + z[12] * z[12]);
  if (c.use_wqf) cf += wqf * attitude_error(z + 6, ident);
  if (live && row == 0) cost_p[b] = cost + cf;
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, int VW>
int launch_rollout_vw(const Consts* c, int H, int B, const T* Zr, const T* Ur, const T* kk,
                      const T* KK, const T* tw, const T* alpha, const T* goal, const T* tp,
                      const T* tq, T* Zn, T* Un, T* cost, cudaStream_t stream) {
  constexpr int bytes = k1_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel<T, VW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + K1_SCEN - 1) / K1_SCEN;
  rollout_kernel<T, VW><<<grid, K1_THREADS, bytes, stream>>>(*c, H, B, Zr, Ur, kk, KK, tw, alpha,
                                                             goal, tp, tq, Zn, Un, cost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rollout(const Consts* c, int H, int B, const T* Zr, const T* Ur, const T* kk,
                   const T* KK, const T* tw, const T* alpha, const T* goal, const T* tp,
                   const T* tq, T* Zn, T* Un, T* cost, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  constexpr int VW = 16 / (int)sizeof(T);
  // 16-byte copies need every streamed row to start on 16 bytes
  const bool aligned = B % VW == 0 && ((reinterpret_cast<size_t>(Zr) | reinterpret_cast<size_t>(Ur) |
                                        reinterpret_cast<size_t>(kk) | reinterpret_cast<size_t>(KK) |
                                        reinterpret_cast<size_t>(tw)) % 16 == 0);
  return aligned ? launch_rollout_vw<T, VW>(c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp, tq, Zn,
                                            Un, cost, stream)
                 : launch_rollout_vw<T, 1>(c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp, tq, Zn,
                                           Un, cost, stream);
}

}  // namespace laf

extern "C" {

int laf_rollout_f32(const laf::Consts* c, int H, int B, const float* Zr, const float* Ur,
                    const float* kk, const float* KK, const float* tw, const float* alpha,
                    const float* goal, const float* tp, const float* tq, float* Zn, float* Un,
                    float* cost, cudaStream_t stream) {
  return laf::launch_rollout<float>(c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp, tq, Zn, Un,
                                    cost, stream);
}

// Bytes of the gain ring, K1's dynamic shared memory per block.
int laf_rollout_ring_bytes(int f64) {
  return f64 ? laf::k1_smem_bytes<double>() : laf::k1_smem_bytes<float>();
}

int laf_rollout_f64(const laf::Consts* c, int H, int B, const double* Zr, const double* Ur,
                    const double* kk, const double* KK, const double* tw, const double* alpha,
                    const double* goal, const double* tp, const double* tq, double* Zn,
                    double* Un, double* cost, cudaStream_t stream) {
  return laf::launch_rollout<double>(c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp, tq, Zn, Un,
                                     cost, stream);
}

}  // extern "C"
