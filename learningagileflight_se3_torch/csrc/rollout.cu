// K1: fused closed-loop rollout with stage and terminal cost.
//
// Replaces learningagileflight_se3_tpu/ops/rollout_pallas.py
// rollout_forward_pallas (kernel _make_kernel).  Plain PyTorch version:
// ops/rollout.py rollout_forward_plain.
//
// One thread per scenario; the time loop runs inside the thread with the
// 17-float state and the cost in registers.  Layout time-major, batch-last:
// entry (j, i, b) of an (H, n, B) tensor is at (j*n + i)*B + b, so a warp's
// 32 threads read 32 neighbouring addresses.  Bound by the per-step gain
// reads (kk, KK: 72 values a step) and, at small batch, by latency.
#include "lane_algebra.cuh"

namespace laf {

template <typename T>
__global__ void __launch_bounds__(BLOCK)
rollout_kernel(const Consts c, const int H, const int B,
               const T* __restrict__ Zr, const T* __restrict__ Ur,
               const T* __restrict__ kk, const T* __restrict__ KK,
               const T* __restrict__ tw, const T* __restrict__ alpha_p,
               const T* __restrict__ goal_p, const T* __restrict__ tp_p,
               const T* __restrict__ tq_p,
               T* __restrict__ Zn, T* __restrict__ Un, T* __restrict__ cost_p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
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

  for (int j = 0; j < H; ++j) {
    const size_t j17 = (size_t)j * NZ * sB, j4 = (size_t)j * NU * sB;
    T dz[NZ], u[NU];
#pragma unroll
    for (int r = 0; r < NZ; ++r) dz[r] = z[r] - Zr[j17 + r * sB + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = Ur[j4 + i * sB + b] + alpha * kk[j4 + i * sB + b];
#pragma unroll
    for (int r = 0; r < NZ; ++r) {
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] += KK[((size_t)j * NU + i) * NZ * sB + r * sB + b] * dz[r];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = nclip(u[i], lb, ub);

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
    cst += tw[(size_t)j * sB + b] * tra;
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

#pragma unroll
    for (int i = 0; i < NZ; ++i) Zn[j17 + i * sB + b] = z[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Un[j4 + i * sB + b] = u[i];
  }

  // ---- terminal cost on the last state ----
  T cf = wrf * ((z[0] - goal[0]) * (z[0] - goal[0]) + (z[1] - goal[1]) * (z[1] - goal[1]) +
                (z[2] - goal[2]) * (z[2] - goal[2]));
  cf += wvf * (z[3] * z[3] + z[4] * z[4] + z[5] * z[5]);
  cf += wwf * (z[10] * z[10] + z[11] * z[11] + z[12] * z[12]);
  if (c.use_wqf) cf += wqf * attitude_error(z + 6, ident);
  cost_p[b] = cost + cf;
}

template <typename T>
int launch_rollout(const Consts* c, int H, int B, const T* Zr, const T* Ur, const T* kk,
                   const T* KK, const T* tw, const T* alpha, const T* goal, const T* tp,
                   const T* tq, T* Zn, T* Un, T* cost, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  rollout_kernel<T><<<grid, BLOCK, 0, stream>>>(*c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp,
                                                tq, Zn, Un, cost);
  return (int)cudaGetLastError();
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

int laf_rollout_f64(const laf::Consts* c, int H, int B, const double* Zr, const double* Ur,
                    const double* kk, const double* KK, const double* tw, const double* alpha,
                    const double* goal, const double* tp, const double* tq, double* Zn,
                    double* Un, double* cost, cudaStream_t stream) {
  return laf::launch_rollout<double>(c, H, B, Zr, Ur, kk, KK, tw, alpha, goal, tp, tq, Zn, Un,
                                     cost, stream);
}

}  // extern "C"
