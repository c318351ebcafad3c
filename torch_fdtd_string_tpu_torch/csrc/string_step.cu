// Fused string step for NVIDIA Hopper (sm_90a): all T audio-rate steps of B
// independent strings in one launch.
//
// Replaces torch_fdtd_string_tpu/ops/pallas_step.py::_kernel, pluck
// specialization: no bow, no hammer, no MMS forcing, adaptive damped block
// Gauss-Seidel coupling with poison-only exits (gmres_rescue=False), the
// surface-integral readout and optional collect_state streaming.  The plain
// PyTorch version of the same algorithm is
// ops/string_kernel.py::string_chunked_reference.
//
// Design: one CTA per string, one thread per grid point.  The block width W
// is max(M_t, M_l) rounded up to whole warps (288 for the first nsynth-like
// batch, M_t=172, M_l=262), and each PCR solve takes ceil(log2 W) levels.
// The whole time loop runs inside the block with u^{n-1}, u^{n-2}, z^{n-1},
// z^{n-2} and the PCR work arrays in shared memory (19 W + 128 floats,
// 22 KB at W=288).
// Cross-grid interpolation reads shared memory at the lo/hi indices
// directly; per-string reductions (the sweep residuals, max|u| and the
// surface integrals) are block reductions, so every string leaves its own
// Gauss-Seidel loop as soon as it has converged, turned hopeless or NaN.
//
// What bounds it on this card: it is latency-bound.  Each step is a
// sequential chain of ~50 __syncthreads phases (one per PCR level, two PCR
// solves per sweep, 1-3 sweeps per step), and a batch of B=24 strings
// occupies only 24 of the 132 SMs.  Device-memory traffic is small: the f0
// column in, two readout floats and, with collect_state, M_t + M_l floats of
// state out per string and step, written coalesced.  Making it fast (several
// strings per CTA, warp-level PCR with shuffles, fewer barriers) is later
// work.
//
// Entry point: string_step_launch (plain C, loaded with ctypes); it returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

struct Params {
  const float* f0;     // (B, T)
  const float* kappa;  // (B,)
  const float* alpha;  // (B,)
  const float* t60;    // (B, 4): freq1, time1, freq2, time2
  const float* u1;     // (B, M_t) row n-1
  const float* u2;     // (B, M_t) row n-2
  const float* z1;     // (B, M_l)
  const float* z2;     // (B, M_l)
  float* uout;         // (B, T)
  float* zout;         // (B, T)
  float* u1_out;       // (B, M_t) final carry
  float* u2_out;
  float* z1_out;       // (B, M_l)
  float* z2_out;
  float* state_u;      // (T, B, M_t) or null
  float* state_z;      // (T, B, M_l) or null
  int B, T, M_t, M_l, levels, iters;
  // constants folded in double on the host, then rounded to float, as the
  // JAX kernel folds its Python-float constants
  float k, k2, k4, theta, c_half, c_a0, two_t, two_two_t, lambda_c, two_pi;
  float ln10_6, inner_eps, M_t_sem;
};

constexpr float kOmegaFloor = 0.0625f;
constexpr int kNumArrays = 19;  // W-wide shared arrays, see the layout below
constexpr int kRedFloats = 128;

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that propagates NaN, as jnp.max / torch.amax do
  return (a != a || a > b) ? a : b;
}

struct Interp {
  int lo, hi;
  float frac, mask;
};

// linear resample index set from n_in to n_out points (pallas_step.py:306-313)
__device__ __forceinline__ Interp interp_idx(float itf, float n_in, float n_out,
                                             int W) {
  const float denom = fmaxf(n_out - 1.0f, 1.0f);
  const float posn = fminf(fmaxf(itf * (n_in - 1.0f) / denom, 0.0f), n_in - 1.0f);
  const float lo = floorf(posn);
  Interp r;
  r.frac = posn - lo;
  r.lo = min(max(static_cast<int>(lo), 0), W - 1);
  r.hi = min(r.lo + 1, max(static_cast<int>(n_in) - 1, 0));
  r.mask = itf < n_out ? 1.0f : 0.0f;
  return r;
}

__device__ __forceinline__ float interp(const float* src, const Interp& d) {
  return (src[d.lo] * (1.0f - d.frac) + src[d.hi] * d.frac) * d.mask;
}

// Block-wide reduction of N values per thread; every thread gets the result.
// Warp butterflies, then each thread folds the per-warp partials in order.
template <int N, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* sred) {
  __syncthreads();  // the previous reduction's readers are done with sred
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float o = __shfl_xor_sync(0xffffffffu, v[j], off);
      v[j] = kMax ? nan_max(v[j], o) : v[j] + o;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) sred[j * 32 + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float r = sred[j * 32];
    for (int w = 1; w < nwarps; ++w)
      r = kMax ? nan_max(r, sred[j * 32 + w]) : r + sred[j * 32 + w];
    v[j] = r;
  }
}

// Masked parallel cyclic reduction, normalized form (pallas_step.py:219-241).
// Thread i owns row i; neighbours at distance s come through shared memory,
// ping-ponging between two buffer sets so each level needs one barrier.
// Padded rows are identity and out-of-range neighbours read as zero.
__device__ __forceinline__ float pcr(float sub, float diag, float sup, float rhs,
                                     float* buf, int levels) {
  const int W = blockDim.x, i = threadIdx.x;
  const float rb = 1.0f / diag;
  float a = sub * rb, c = sup * rb, d = rhs * rb;
  int s = 1;
  for (int l = 0; l < levels; ++l) {
    float* A = buf + (l & 1) * 3 * W;
    float* C = A + W;
    float* D = C + W;
    A[i] = a;
    C[i] = c;
    D[i] = d;
    __syncthreads();
    const bool has_m = i - s >= 0, has_p = i + s < W;
    const float a_m = has_m ? A[i - s] : 0.0f, a_p = has_p ? A[i + s] : 0.0f;
    const float c_m = has_m ? C[i - s] : 0.0f, c_p = has_p ? C[i + s] : 0.0f;
    const float d_m = has_m ? D[i - s] : 0.0f, d_p = has_p ? D[i + s] : 0.0f;
    const float rD = 1.0f / (1.0f - a * c_m - c * a_p);
    const float na = -(a * a_m) * rD;
    const float nc = -(c * c_p) * rD;
    const float nd = (d - a * d_m - c * d_p) * rD;
    a = na;
    c = nc;
    d = nd;
    s <<= 1;
  }
  return d;
}

__global__ void __launch_bounds__(1024) string_step_kernel(const Params p) {
  extern __shared__ float sm[];
  const int W = blockDim.x, i = threadIdx.x, b = blockIdx.x;
  const int T = p.T;
  const float itf = static_cast<float>(i);

  // shared-memory layout, W floats each
  float* su1 = sm;           // stored state, row n-1 (unmasked)
  float* su2 = sm + W;       // row n-2
  float* sz1 = sm + 2 * W;
  float* sz2 = sm + 3 * W;
  float* pcr_buf = sm + 4 * W;  // 6 W: two (a, c, d) sets
  float* sLam = sm + 10 * W;    // Lambda = Dxb u1
  float* sP = sm + 11 * W;      // t-grid source of the t->l interpolation
  float* sIz1 = sm + 12 * W;    // interpolated z (l->t)
  float* sIz2 = sm + 13 * W;
  float* sQ1 = sm + 14 * W;     // Lambda Dxb(Iz), operand of K_tl's Dxf
  float* sQ2 = sm + 15 * W;
  float* sIu = sm + 16 * W;     // interpolated u-term (t->l)
  float* sUg = sm + 17 * W;     // Gauss-Seidel u iterate
  float* sZc = sm + 18 * W;     // current z iterate
  float* sred = sm + kNumArrays * W;

  su1[i] = i < p.M_t ? p.u1[(size_t)b * p.M_t + i] : 0.0f;
  su2[i] = i < p.M_t ? p.u2[(size_t)b * p.M_t + i] : 0.0f;
  sz1[i] = i < p.M_l ? p.z1[(size_t)b * p.M_l + i] : 0.0f;
  sz2[i] = i < p.M_l ? p.z2[(size_t)b * p.M_l + i] : 0.0f;
  const float kappa = p.kappa[b], alpha = p.alpha[b];
  const float freq1 = p.t60[4 * b], time1 = p.t60[4 * b + 1];
  const float freq2 = p.t60[4 * b + 2], time2 = p.t60[4 * b + 3];
  const float k = p.k, theta = p.theta, inner_eps = p.inner_eps;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- per-step grid and loss terms (pallas_step.py:248-291) ----------
    const float gamma = 2.0f * p.f0[(size_t)b * T + t];
    const float K = kappa * gamma;
    const float g2 = gamma * gamma, g4 = g2 * g2, KK = K * K;
    const float h_1 = p.lambda_c *
        sqrtf((g2 * p.k2 + sqrtf(g4 * p.k4 + 16.0f * KK * p.k2 * p.two_t)) /
              p.two_two_t);
    const float N_t = floorf(1.0f / h_1);
    const float h_t = 1.0f / N_t;
    const float h_2 = p.lambda_c * gamma * alpha * k;
    const float N_l = floorf(1.0f / h_2);
    const float h_l = 1.0f / N_l;
    const float n_t = N_t + 1.0f, n_l = N_l + 1.0f;

    const float gg = gamma != 0.0f ? gamma : 1.0f;
    const float g2s = gg * gg;
    const float x1 = p.two_pi * freq1, x2 = p.two_pi * freq2;
    const bool stiff = K > 0.0f;
    const float zeta1 = stiff ? -g2 + sqrtf(g4 + 4.0f * KK * (x1 * x1)) : freq1 * freq1 / g2s;
    const float zeta2 = stiff ? -g2 + sqrtf(g4 + 4.0f * KK * (x2 * x2)) : freq2 * freq2 / g2s;
    const bool lossy = (freq1 * time1 * freq2 * time2) != 0.0f;
    const float st1 = time1 != 0.0f ? time1 : 1.0f;
    const float st2 = time2 != 0.0f ? time2 : 1.0f;
    const float scale = p.ln10_6 / (zeta1 - zeta2);
    const float sig0 = scale * (lossy ? -zeta2 / st1 + zeta1 / st2 : 0.0f);
    const float sig1 = scale * (lossy ? 1.0f / st1 - 1.0f / st2 : 0.0f);

    const float live_t = itf < n_t ? 1.0f : 0.0f;
    const float live_l = itf < n_l ? 1.0f : 0.0f;
    // masked neighbour reads; zero fill outside [0, W) like the lane shifts
    auto U1 = [&](int j) { return (j >= 0 && j < W) ? su1[j] * (static_cast<float>(j) < n_t ? 1.0f : 0.0f) : 0.0f; };
    auto U2 = [&](int j) { return (j >= 0 && j < W) ? su2[j] * (static_cast<float>(j) < n_t ? 1.0f : 0.0f) : 0.0f; };
    auto Z1 = [&](int j) { return (j >= 0 && j < W) ? sz1[j] * (static_cast<float>(j) < n_l ? 1.0f : 0.0f) : 0.0f; };
    auto Z2 = [&](int j) { return (j >= 0 && j < W) ? sz2[j] * (static_cast<float>(j) < n_l ? 1.0f : 0.0f) : 0.0f; };
    const float u1 = U1(i), u2 = U2(i), z1 = Z1(i), z2 = Z2(i);

    const float gamma_k = g2 * p.k2;
    const float phi_pow = gamma_k * (alpha * alpha - 1.0f) / 4.0f;
    const float lam = (u1 - U1(i - 1)) / h_t;
    const float lam2 = lam * lam;
    const Interp lt = interp_idx(itf, n_l, n_t, W);  // z (l-grid) -> t-grid
    const Interp tl = interp_idx(itf, n_t, n_l, W);  // t-grid -> l-grid
    const float hh_t = h_t * h_t, hh_l = h_l * h_l;

    // interpolation reads stay inside the live source region (lo, hi < n_in),
    // where the masked and the stored values coincide
    const float iz1 = interp(sz1, lt);
    const float iz2 = interp(sz2, lt);
    sLam[i] = lam;
    sP[i] = lam * ((u2 - U2(i - 1)) / h_t);
    sIz1[i] = iz1;
    sIz2[i] = iz2;
    __syncthreads();

    const float d_next = i + 1 < W ? sLam[i + 1] * sLam[i + 1] : 0.0f;
    const float iu2 = interp(sP, tl);
    const float q1 = lam * ((iz1 - (i > 0 ? sIz1[i - 1] : 0.0f)) / h_t);
    const float q2 = lam * ((iz2 - (i > 0 ? sIz2[i - 1] : 0.0f)) / h_t);
    sQ1[i] = q1;
    sQ2[i] = q2;
    sIu[i] = iu2;
    __syncthreads();

    // K_tl w = -phi_pow Dxf(Lambda Dxb w), K_lt w = -phi_pow Dxf w
    const float K_tl1 = -phi_pow * (((i + 1 < W ? sQ1[i + 1] : 0.0f) - q1) / h_t);
    const float K_tl2 = -phi_pow * (((i + 1 < W ? sQ2[i + 1] : 0.0f) - q2) / h_t);
    const float K_lt2 = -phi_pow * (((i + 1 < W ? sIu[i + 1] : 0.0f) - iu2) / h_l);

    // ---- LHS tridiagonals (pallas_step.py:360-374) ------------------------
    const float a_t = p.c_a0 - 2.0f * sig1 * k / hh_t;
    const float b_t = theta + 2.0f * sig0 * k + 4.0f * sig1 * k / hh_t;
    const float sub_t = (i >= 1 && itf < n_t) ? a_t - phi_pow * lam2 / hh_t : 0.0f;
    const float diag_t = itf < n_t ? b_t + phi_pow * (lam2 + d_next) / hh_t : 1.0f;
    const float sup_t = itf < n_t - 1.0f ? a_t - phi_pow * d_next / hh_t : 0.0f;
    const float a_l = -2.0f * sig1 * k / hh_l;
    const float b_l = 1.0f + 2.0f * sig0 * k + 4.0f * sig1 * k / hh_l;
    const float sub_l = (i >= 1 && itf < n_l) ? a_l : 0.0f;
    const float diag_l = itf < n_l ? b_l : 1.0f;
    const float sup_l = itf < n_l - 1.0f ? a_l : 0.0f;

    // ---- RHS B w1 + C w2 (pallas_step.py:376-415) -------------------------
    const float u1p = U1(i + 1), u1m = U1(i - 1);
    const float u2p = U2(i + 1), u2m = U2(i - 1);
    const float theta_u1 = theta * u1 + p.c_half * (u1p + u1m);
    const float theta_u2 = theta * u2 + p.c_half * (u2p + u2m);
    const float dxx_u1 = (u1p - 2.0f * u1 + u1m) / hh_t;
    const float dxx_u2 = (u2p - 2.0f * u2 + u2m) / hh_t;
    const float pent = U1(i + 2) - 4.0f * u1p + 6.0f * u1 - 4.0f * u1m + U1(i - 2);
    const float corr = (i == 1 || itf == n_t - 2.0f) ? u1 : 0.0f;
    const float dxxxx_u1 = (pent + corr) / (hh_t * hh_t);
    const float V_u2 = -phi_pow * (lam2 * u2m - (lam2 + d_next) * u2 + d_next * u2p) / hh_t;
    const float B1u1 = -2.0f * theta_u1 - gamma_k * dxx_u1 + KK * p.k2 * dxxxx_u1;
    const float C1u2 = theta_u2 - 2.0f * sig0 * k * u2 + 2.0f * sig1 * k * dxx_u2 + V_u2;
    const float rhs_u = (B1u1 + C1u2 + 2.0f * K_tl1 + K_tl2) * live_t;
    const float dxx_z1 = (Z1(i + 1) - 2.0f * z1 + Z1(i - 1)) / hh_l;
    const float dxx_z2 = (Z2(i + 1) - 2.0f * z2 + Z2(i - 1)) / hh_l;
    const float B4z1 = -2.0f * z1 - gamma_k * (alpha * alpha) * dxx_z1;
    const float C4z2 = (1.0f - 2.0f * sig0 * k) * z2 + 2.0f * sig1 * k * dxx_z2;
    const float z_keep = fminf(fmaxf(N_t + N_l + 2.0f - p.M_t_sem, 0.0f), n_l);
    const float rhs_z = (B4z1 + C4z2 + K_lt2) * (itf < z_keep ? 1.0f : 0.0f);

    // ---- adaptive damped block Gauss-Seidel (pallas_step.py:505-578) ------
    float u_c = u1, z_c = z1, omega = 1.0f, prev = INFINITY, scale_u = 0.0f;
    bool hopeless = false;
    float K_tl = K_tl1;  // sweep 1 reuses the RHS pass's z interpolation
    for (int sweep = 0;; ++sweep) {
      if (sweep > 0) {
        sZc[i] = z_c;
        __syncthreads();
        const float izc = interp(sZc, lt);
        sIz1[i] = izc;
        __syncthreads();
        const float q = lam * ((izc - (i > 0 ? sIz1[i - 1] : 0.0f)) / h_t);
        sQ1[i] = q;
        __syncthreads();
        K_tl = -phi_pow * (((i + 1 < W ? sQ1[i + 1] : 0.0f) - q) / h_t);
      }
      const float u_g = pcr(sub_t, diag_t, sup_t, -rhs_u - K_tl, pcr_buf, p.levels);
      sUg[i] = u_g;
      __syncthreads();
      sP[i] = lam * ((u_g - (i > 0 ? sUg[i - 1] : 0.0f)) / h_t);
      __syncthreads();
      const float iu = interp(sP, tl);
      sIu[i] = iu;
      __syncthreads();
      const float K_lt = -phi_pow * (((i + 1 < W ? sIu[i + 1] : 0.0f) - iu) / h_l);
      const float z_g = pcr(sub_l, diag_l, sup_l, -rhs_z - K_lt, pcr_buf, p.levels);

      const float u_c2 = u_c + omega * (u_g - u_c);
      const float z_c2 = z_c + omega * (z_g - z_c);
      float red[3] = {fabsf(u_g - u_c), fabsf(z_g - z_c), fabsf(u_c2)};
      block_reduce<3, true>(red, sred);
      const float delta = red[0] + red[1];
      const bool grew = delta > prev;
      const bool hop = grew && omega <= kOmegaFloor;
      if (grew) omega = fmaxf(omega * 0.5f, kOmegaFloor);
      u_c = u_c2;
      z_c = z_c2;
      prev = delta;
      hopeless = hop;
      scale_u = red[2] + inner_eps;
      const bool live_err = delta > inner_eps * scale_u && !hop;
      if (!live_err || sweep + 1 >= p.iters) break;
    }

    // ---- poison untrusted exits, Dirichlet rows (pallas_step.py:593-609,
    // 765-766); multiplying keeps a NaN row NaN ------------------------------
    const bool bad = hopeless || !(prev < INFINITY) || prev > inner_eps * scale_u;
    const float u_n = (bad ? NAN : u_c) * live_t * (i != 0 ? 1.0f : 0.0f) *
                      (itf != N_t ? 1.0f : 0.0f);
    const float z_n = z_c * live_l * (i != 0 ? 1.0f : 0.0f) * (itf != N_l ? 1.0f : 0.0f);

    // ---- surface-integral readout (pallas_step.py:771-774) ----------------
    float sums[2] = {u_n - su1[i], z_n - sz1[i]};
    block_reduce<2, false>(sums, sred);
    if (i == 0) {
      const float w_out = 0.5f * h_t;
      p.uout[(size_t)b * T + t] = sums[0] * w_out / k;
      p.zout[(size_t)b * T + t] = sums[1] * w_out / k;
    }
    if (p.state_u != nullptr) {
      if (i < p.M_t) p.state_u[((size_t)t * p.B + b) * p.M_t + i] = u_n;
      if (i < p.M_l) p.state_z[((size_t)t * p.B + b) * p.M_l + i] = z_n;
    }
    // every read of the stored rows lies before block_reduce's barriers
    su2[i] = su1[i];
    su1[i] = u_n;
    sz2[i] = sz1[i];
    sz1[i] = z_n;
    __syncthreads();
  }

  if (i < p.M_t) {
    p.u1_out[(size_t)b * p.M_t + i] = su1[i];
    p.u2_out[(size_t)b * p.M_t + i] = su2[i];
  }
  if (i < p.M_l) {
    p.z1_out[(size_t)b * p.M_l + i] = sz1[i];
    p.z2_out[(size_t)b * p.M_l + i] = sz2[i];
  }
}

}  // namespace

extern "C" int string_step_launch(
    const float* f0, const float* kappa, const float* alpha, const float* t60,
    const float* u1, const float* u2, const float* z1, const float* z2,
    float* uout, float* zout, float* u1_out, float* u2_out, float* z1_out,
    float* z2_out, float* state_u, float* state_z,
    int B, int T, int M_t, int M_l, int W, int M_t_sem, int coupling_iters,
    double k, double theta, double lambda_c, void* stream) {
  if (W < 32 || W > 1024 || W % 32 != 0 || W < M_t || W < M_l ||
      B < 1 || T < 1 || coupling_iters < 1 || (state_u == nullptr) != (state_z == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.f0 = f0;
  p.kappa = kappa;
  p.alpha = alpha;
  p.t60 = t60;
  p.u1 = u1;
  p.u2 = u2;
  p.z1 = z1;
  p.z2 = z2;
  p.uout = uout;
  p.zout = zout;
  p.u1_out = u1_out;
  p.u2_out = u2_out;
  p.z1_out = z1_out;
  p.z2_out = z2_out;
  p.state_u = state_u;
  p.state_z = state_z;
  p.B = B;
  p.T = T;
  p.M_t = M_t;
  p.M_l = M_l;
  int levels = 0;
  while ((1 << levels) < W) ++levels;
  p.levels = levels;
  p.iters = coupling_iters;
  p.k = static_cast<float>(k);
  p.k2 = static_cast<float>(k * k);
  p.k4 = static_cast<float>(pow(k, 4.0));
  p.theta = static_cast<float>(theta);
  p.c_half = static_cast<float>((1.0 - theta) * 0.5);
  p.c_a0 = static_cast<float>((1.0 - theta) / 2.0);
  p.two_t = static_cast<float>(2.0 * theta - 1.0);
  p.two_two_t = static_cast<float>(2.0 * (2.0 * theta - 1.0));
  p.lambda_c = static_cast<float>(lambda_c);
  p.two_pi = static_cast<float>(2.0 * M_PI);
  p.ln10_6 = static_cast<float>(6.0 * log(10.0));
  p.inner_eps = static_cast<float>(100.0 * 1.1920928955078125e-07);  // 100 FLT_EPSILON
  p.M_t_sem = static_cast<float>(M_t_sem);

  const size_t smem = (static_cast<size_t>(kNumArrays) * W + kRedFloats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      string_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  string_step_kernel<<<B, W, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
