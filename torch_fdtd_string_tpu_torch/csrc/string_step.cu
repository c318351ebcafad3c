// Fused string step for NVIDIA Hopper (sm_90a): all T audio-rate steps of B
// independent strings in one launch.
//
// Replaces torch_fdtd_string_tpu/ops/pallas_step.py::_kernel, in 22
// compile-time specializations: with or without the bow branch, with or
// without the hammer branch, the surface-integral or the interpolated pickup
// readout, and poison-only exits (gmres_rescue=False, the first pass) or the
// in-kernel GMRES rescue (kGmres, the rescue ladder's re-run); and for
// plucked strings alone, with either readout, the manufactured-solution
// (MMS) forcing of the verification runs (kMms, first pass and GMRES) and
// the fixed sweep schedule (kFixed).  collect_state streaming is a runtime
// option.  The plain PyTorch version of the same algorithm is
// ops/string_kernel.py::string_chunked_reference.
//
// Design: one CTA per string, one thread per grid point.  The block width W
// is max(M_t, M_l) rounded up to whole warps (288 for the first nsynth-like
// batch, M_t=172, M_l=262), and each PCR solve takes ceil(log2 W) levels.
// The whole time loop runs inside the block with u^{n-1}, u^{n-2}, z^{n-1},
// z^{n-2} and the PCR work arrays in shared memory (19 W + 128 floats,
// 22 KB at W=288; the bow adds one W-array for its force profile).
// Cross-grid interpolation reads shared memory at the lo/hi indices
// directly; per-string reductions (the sweep residuals, max|u|, the
// readouts, the bow's probe velocity and the hammer's contact displacement)
// are block reductions, so every string leaves its own Gauss-Seidel loop as
// soon as it has converged, turned hopeless or NaN.  The per-string
// excitation scalars (the hammer's inner fixed point of at most 40
// iterations, the friction law, the hammer displacement carry) are computed
// by every thread alike from the reduced values: the work is warp-uniform
// and needs no barrier of its own.
//
// What bounds it on this card: it is latency-bound.  Each step is a
// sequential chain of ~50 __syncthreads phases (one per PCR level, two PCR
// solves per sweep, 1-3 sweeps per step; an excitation adds one reduction
// per step and one per sweep), and a batch of B=24 strings occupies only 24
// of the 132 SMs.  Device-memory traffic is small: the f0 column (and the
// four bow signals) in, the readouts and probe traces out and, with
// collect_state, M_t + M_l floats of state out per string and step, written
// coalesced.  Fewer barriers do not make it faster: a step of three
// barriers per PCR solve, warp-level levels by shuffles and stencils without
// round trips gave the same results bit for bit and ran 8-25% slower on
// plucked strings (PERF.md), since each PCR level's time is its own
// dependent chain (reciprocal, loads, products), not its barrier.
//
// The GMRES rescue (kGmres; pallas_step.py:579-764): a string whose sweeps
// exit untrusted (hopeless, non-finite, or above tolerance at the cap)
// solves the step's coupled system again by GMRES(16) on the z fixed point
// (I - G) z = c, G z the z of one RHS-free sweep from z: the matvec is two
// PCR solves and the interpolations, the Krylov basis lives in shared
// memory (17 W floats after the sweep arrays), modified Gram-Schmidt takes
// one block reduction per basis row, and every thread runs the Givens
// recurrence alike from the reduced values while thread 0 keeps R, g, cs
// and sn in shared memory and back-substitutes.  `bad` comes from block
// reductions, so the whole CTA takes the branch or none of it does.  It is
// compiled out of the first pass's instances, whose code it would slow.
//
// Width buckets (replaces pallas_step.py::string_chunked_bucketed and
// _build_bucketed_fn): a launch may run a subset of a batch at a narrower
// block width.  `rows` maps each CTA to its row of the full batch, and the
// row strides ld_t / ld_l and the state's batch size B_rows are the full
// batch's, so each CTA reads its string's inputs and writes its outputs,
// traces and state rows in place: no gather or scatter copy of the (T, B, M)
// field.  M_t / M_l are the lanes this launch reads and writes; M_t_sem is
// the allocation's M_t, which sets the z live-row count and the bow's
// spatial axis, so a string's result does not depend on its bucket beyond
// the order of the block reductions.  ops/string_kernel.py launches one
// group per stream.
//
// MMS forcing (manufactured, pallas_step.py:392-412): the closed-form
// source of the verification runs is subtracted from the u and z RHS before
// the z live-row mask, u at its grid's x = (clip(2i/N_t, 0, 2) - 1)/2 and z
// at x = 1/2, at time (n - [mms_centered]) k with n the step's index counted
// from 2 at the launch's first step, as the JAX kernel counts it (every
// launch of the port starts at the run's step 2).  p_a is read through the
// CTA->row map, so the bucketed launch and the rows-only GMRES re-run carry
// it too.  It costs four accurate cosf per lane and, per string, one cosf
// and one expf per step: ~32 float operations per lane and step.  MMS and
// the fixed schedule are compile-time parameters of the pluck instances
// only: as runtime branches they cost the other first-pass instances, which
// sit at the 64-register bound, more spills and up to 7% (bow) of their
// time; no path runs either with a bow or a hammer, and the launcher
// refuses that combination.
//
// The fixed schedule (coupling_fixed > 0, pallas_step.py:517-519, :562-570):
// exactly that many plain sweeps (omega 1, the first reusing the RHS pass's
// z interpolation), with none of the adaptive loop's block reductions and
// no exit test, so no exit is untrusted: no poison and no rescue (the host
// selects a kGmres=false instance).  Saving the reductions is the point of
// the schedule.
//
// Entry point: string_step_launch (plain C, loaded with ctypes) takes a
// LaunchArgs struct and returns the cudaError_t of the launch.
//
// The instrumented build (-DSTRING_STEP_CLOCKS, a library of its own that
// tools/profile_kernel.py loads; the main path never does): thread 0 of each
// CTA adds the clock64() cycles of each phase class of the step loop into
// shared counters, and writes them per string into a (B_rows, kClockSlots)
// int64 buffer, the last column the count of Gauss-Seidel sweeps.  A mark
// charges the cycles since the previous mark to the phase that just ended;
// in the plain build it compiles to nothing.  Its entry point is
// string_step_launch_clocks.

#include <cuda_runtime.h>

#include <float.h>
#include <math.h>
#include <stddef.h>

// The launch arguments, passed by pointer from ops/string_kernel.py's
// _LaunchArgs (same fields, same order); struct_size guards the layout.
// Inputs: f0 and the bow's x_b, v_b, F_b, wid are (B, T); kappa, alpha, pos
// (the pickup), phi_0, phi_1, bmask, x_H, w_H, M_r, alpha_H, hmask and the
// initial hammer displacements uH1, uH2 are (B,); t60 is (B, 4) (freq1,
// time1, freq2, time2); u1, u2 are rows n-1, n-2 (B, M_t), z1, z2 (B, M_l).
// With manufactured, p_a is the (B,) MMS amplitude.
// Outputs: uout, zout and, with an excitation, the probe traces v_r, F_H,
// u_H are (B, T); the final carry u1_out, u2_out (B, M_t), z1_out, z2_out
// (B, M_l); state_u (T, B, M_t) and state_z (T, B, M_l), or both null.
// B is the number of strings (CTAs) of this launch.  With `rows` set, CTA j
// runs row rows[j] of arrays whose batch size is B_rows: the shapes above
// then read B_rows for B, and the u-arrays (u1, u2, u1_out, u2_out, state_u
// rows) have the row stride ld_t >= M_t, the z-arrays ld_l >= M_l.  Without
// `rows`, B_rows = B, ld_t = M_t and ld_l = M_l.
struct LaunchArgs {
  int struct_size, B, T, M_t, M_l, W, M_t_sem, coupling_iters;
  int has_bow, has_hammer, surface_integral, gmres;
  int B_rows, ld_t, ld_l;
  int manufactured, mms_centered, coupling_fixed;
  double k, theta, lambda_c, relative_error;
  const int *rows;
  const float *f0, *kappa, *alpha, *pos, *t60, *u1, *u2, *z1, *z2;
  const float *x_b, *v_b, *F_b, *wid, *phi_0, *phi_1, *bmask;
  const float *x_H, *w_H, *M_r, *alpha_H, *hmask, *uH1, *uH2, *p_a;
  float *uout, *zout, *u1_out, *u2_out, *z1_out, *z2_out, *state_u, *state_z;
  float *v_r, *F_H, *u_H;
};

namespace {

// The kernel's parameters: the launch arguments, the PCR level count and
// constants folded in double on the host, then rounded to float, as the JAX
// kernel folds its Python-float constants.
struct Params : LaunchArgs {
  long long* clocks;  // the instrumented build's (B_rows, kClockSlots) counts
  int levels;
  float k_f, k2, k4, theta_f, c_half, c_a0, two_t, two_two_t, lambda_f, two_pi;
  float ln10_6, inner_eps, M_t_sem_f;
  float pi_f, mu2, two_mu2;  // the MMS forcing's pi, pi^2 and 2 pi^2
};

constexpr float kOmegaFloor = 0.0625f;
constexpr float kHammerClamp = -0.01f;  // M_HD_CLAMP, pallas_step.py:46
constexpr int kHammerMaxIter = 40;      // KernelConsts.hammer_max_iter
constexpr int kNumArrays = 19;  // W-wide shared arrays, see the layout below
constexpr int kRedFloats = 128;
// the GMRES rescue: Krylov dimension (KernelConsts.gmres_m), its W-wide
// basis rows, and the floats of its small arrays (R m x m, g m+1, cs m,
// sn m, the Hessenberg column m+1, y m; 338, rounded up)
constexpr int kGmresM = 16;
constexpr int kGmresRows = kGmresM + 1;
constexpr int kGmresSmall = 352;
// happy-breakdown guard of the rescue's divisions: sqrt(FLT_MIN)
// (pallas_step.py:611)
constexpr float kTiny = 1.0842021724855044e-19f;

// the instrumented build's phase classes (its counters' columns)
enum Phase {
  kPhStart,      // step start: the f0 load, the grid and loss terms
  kPhRhs,        // the RHS pass and the tridiagonals
  kPhPcrT,       // PCR on t
  kPhStencilTL,  // the t->l stencil: K_lt of the u iterate
  kPhPcrL,       // PCR on l
  kPhStencilLT,  // the l->t stencil: K_tl of a z iterate
  kPhExit,       // relaxation and the exit reduction
  kPhReadout,    // readout, state write, the carry
  kPhExcitation, // the bow's and hammer's reductions and scalars
  kPhGmres,      // the rescue, apart from its solves and stencils
  kClockPhases
};
constexpr int kClockSlots = kClockPhases + 1;

// floats of dynamic shared memory the kernel lays out (string_step_kernel),
// and the instrumented build's counters after them, 8-byte aligned
__host__ __device__ constexpr size_t shared_floats(int W, bool bow, bool gmres) {
  return static_cast<size_t>(kNumArrays + (bow ? 1 : 0)) * W + kRedFloats +
         (gmres ? static_cast<size_t>(kGmresRows) * W + kGmresSmall : 0);
}
__host__ __device__ constexpr size_t clock_offset(int W, bool bow, bool gmres) {
  return (shared_floats(W, bow, gmres) + 1) / 2 * 2;
}

struct Clocks {
  long long* acc;
  long long last;
  __device__ __forceinline__ void mark(int ph) {
#ifdef STRING_STEP_CLOCKS
    if (threadIdx.x == 0) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
#endif
  }
  __device__ __forceinline__ void sweep() {
#ifdef STRING_STEP_CLOCKS
    if (threadIdx.x == 0) ++acc[kClockPhases];
#endif
  }
};

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that propagates NaN, as jnp.max / torch.amax do
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_sign(float x) {
  // jnp.sign: NaN stays NaN, a signed zero stays itself
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float sdiv(float a, float b) {
  // a / b, 0 where |b| <= kTiny (pallas_step.py:613-615)
  return fabsf(b) > kTiny ? a / (b == 0.0f ? 1.0f : b) : 0.0f;
}

__device__ __forceinline__ float nan_to_num(float x) {
  // jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
  if (x != x) return 0.0f;
  return fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
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

template <bool kBow, bool kHammer, bool kSurface, bool kGmres, bool kMms, bool kFixed>
__global__ void __launch_bounds__(1024) string_step_kernel(const Params p) {
  constexpr bool kExc = kBow || kHammer;
  constexpr int kStepSums = (kBow ? 1 : 0) + (kHammer ? 2 : 0);
  constexpr int kSweepSums = (kBow ? 1 : 0) + (kHammer ? 1 : 0);
  extern __shared__ float sm[];
  const int W = blockDim.x, i = threadIdx.x;
  const int b = p.rows != nullptr ? p.rows[blockIdx.x] : blockIdx.x;  // batch row
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
  float* sRc = sm + kNumArrays * W;  // bow force profile (bow only)
  float* sred = sm + (kNumArrays + (kBow ? 1 : 0)) * W;
  // the GMRES rescue (kGmres only): Krylov basis rows V_0..V_m, then R
  // (column i at i*m), g, cs, sn, the Hessenberg column and y, all written
  // by thread 0 and read after a barrier
  float* sV = sred + kRedFloats;
  float* sR = sV + kGmresRows * W;
  float* sG = sR + kGmresM * kGmresM;
  float* sCs = sG + kGmresRows;
  float* sSn = sCs + kGmresM;
  float* sH = sSn + kGmresM;
  float* sY = sH + kGmresRows;

  su1[i] = i < p.M_t ? p.u1[(size_t)b * p.ld_t + i] : 0.0f;
  su2[i] = i < p.M_t ? p.u2[(size_t)b * p.ld_t + i] : 0.0f;
  sz1[i] = i < p.M_l ? p.z1[(size_t)b * p.ld_l + i] : 0.0f;
  sz2[i] = i < p.M_l ? p.z2[(size_t)b * p.ld_l + i] : 0.0f;
  const float kappa = p.kappa[b], alpha = p.alpha[b];
  const float freq1 = p.t60[4 * b], time1 = p.t60[4 * b + 1];
  const float freq2 = p.t60[4 * b + 2], time2 = p.t60[4 * b + 3];
  const float k = p.k_f, theta = p.theta_f, inner_eps = p.inner_eps;
  const float pos = kSurface ? 0.0f : p.pos[b];
  // per-string excitation constants and the hammer displacement carry
  // (uHs: uH1 the newest, uH2 the one before), uniform across the block
  float phi0 = 0.0f, phi1 = 0.0f, bm = 0.0f;
  float x_H = 0.0f, w_H = 0.0f, M_r = 0.0f, a_H = 0.0f, hm = 0.0f;
  float uH1 = 0.0f, uH2 = 0.0f;
  if constexpr (kBow) {
    phi0 = p.phi_0[b];
    phi1 = p.phi_1[b];
    bm = p.bmask[b];
  }
  if constexpr (kHammer) {
    x_H = p.x_H[b];
    w_H = p.w_H[b] / p.lambda_f;
    M_r = p.M_r[b] / p.lambda_f;
    a_H = p.alpha_H[b];
    hm = p.hmask[b];
  }
  if constexpr (kExc) {
    uH1 = p.uH1[b];
    uH2 = p.uH2[b];
  }
  Clocks clk{nullptr, 0};
#ifdef STRING_STEP_CLOCKS
  clk.acc = reinterpret_cast<long long*>(sm + clock_offset(W, kBow, kGmres));
  if (i < kClockSlots) clk.acc[i] = 0;
  clk.last = clock64();
#endif
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- per-step grid and loss terms (pallas_step.py:248-291) ----------
    const float gamma = 2.0f * p.f0[(size_t)b * T + t];
    const float K = kappa * gamma;
    const float g2 = gamma * gamma, g4 = g2 * g2, KK = K * K;
    const float h_1 = p.lambda_f *
        sqrtf((g2 * p.k2 + sqrtf(g4 * p.k4 + 16.0f * KK * p.k2 * p.two_t)) /
              p.two_two_t);
    const float N_t = floorf(1.0f / h_1);
    const float h_t = 1.0f / N_t;
    const float h_2 = p.lambda_f * gamma * alpha * k;
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
    clk.mark(kPhStart);

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
    float rhs_u0 = B1u1 + C1u2 + 2.0f * K_tl1 + K_tl2;
    const float dxx_z1 = (Z1(i + 1) - 2.0f * z1 + Z1(i - 1)) / hh_l;
    const float dxx_z2 = (Z2(i + 1) - 2.0f * z2 + Z2(i - 1)) / hh_l;
    const float B4z1 = -2.0f * z1 - gamma_k * (alpha * alpha) * dxx_z1;
    const float C4z2 = (1.0f - 2.0f * sig0 * k) * z2 + 2.0f * sig1 * k * dxx_z2;
    float rhs_z = B4z1 + C4z2 + K_lt2;
    if constexpr (kMms) {
      // -forcing k^2, the forcing p_a (c1 cos^2(pi x) + c2 cos(2 pi x))
      // cos(gamma t) exp(-sig0 t), constants folded as the plain version
      // folds them
      const float t_now = (static_cast<float>(t + 2) - (p.mms_centered ? 1.0f : 0.0f)) * k;
      const float c1 = sig0 * sig0 - gamma * gamma - 2.0f * sig0 * sig0;
      const float c2 = p.two_mu2 * (4.0f * KK * p.mu2 + gamma * gamma);
      const float cos_t = cosf(gamma * t_now), exp_t = expf(-sig0 * t_now);
      const float p_a = p.p_a[b];
      auto force = [&](float x) {
        const float cx = cosf(p.pi_f * x);
        return p_a * (c1 * (cx * cx) + c2 * cosf(p.two_pi * x)) * cos_t * exp_t;
      };
      const float x_u = (fminf(fmaxf(2.0f * itf / N_t, 0.0f), 2.0f) - 1.0f) / 2.0f;
      rhs_u0 = rhs_u0 - force(x_u) * p.k2;
      rhs_z = rhs_z - force(0.5f) * p.k2;
    }
    float rhs_u = rhs_u0 * live_t;  // iterate-independent without an excitation
    const float z_keep = fminf(fmaxf(N_t + N_l + 2.0f - p.M_t_sem, 0.0f), n_l);
    rhs_z = rhs_z * (itf < z_keep ? 1.0f : 0.0f);
    clk.mark(kPhRhs);

    // ---- excitation profiles, iterate-independent parts
    // (pallas_step.py:418-447): the bow's raised cosine over the first M_t
    // lanes, normalized by sum|rc|; the hammer's one-hot contact point and
    // its displacement relative to the string at n-1 and n-2 ---------------
    float v_b = 0.0f, F_b = 0.0f, eps_prof = 0.0f, tol_t = 0.0f;
    float eta_1 = 0.0f, eta_2 = 0.0f, f_pow = 0.0f;
    if constexpr (kExc) {
      float rc = 0.0f;
      float r[kStepSums];
      int j = 0;
      if constexpr (kBow) {
        const size_t bt = (size_t)b * T + t;
        v_b = p.v_b[bt];
        F_b = p.F_b[bt];
        const float wid_b = p.wid[bt] * h_t;
        const float xax = (itf + 1.0f) / p.M_t_sem_f;
        const float nmin1 = N_t - 1.0f;
        const float ctr = p.x_b[bt] * nmin1 / p.M_t_sem_f;
        const float wd = wid_b * nmin1 / p.M_t_sem_f;
        const float ind = nan_sign(nan_max(-(xax - ctr - wd / 2.0f) * (xax - ctr + wd / 2.0f), 0.0f));
        rc = 0.5f * ind * (1.0f + cosf(p.two_pi * (xax - ctr) / wd));
        rc = rc * (i < p.M_t_sem ? 1.0f : 0.0f);
        r[j++] = fabsf(rc);
      }
      if constexpr (kHammer) {
        tol_t = static_cast<float>(pow(static_cast<double>(h_t), p.relative_error));
        eps_prof = itf == floorf(x_H * (N_t - 1.0f)) ? 1.0f : 0.0f;
        // masked sums, as the JAX kernel takes them: a NaN anywhere in the
        // row reaches the result
        r[j++] = eps_prof * u1;
        r[j++] = eps_prof * u2;
      }
      block_reduce<kStepSums, false>(r, sred);
      if constexpr (kBow) sRc[i] = rc / r[0];  // read back by this thread only
      if constexpr (kHammer) {
        eta_1 = uH1 - r[kStepSums - 2];
        eta_2 = uH2 - r[kStepSums - 1];
        // iteration-invariant factor of the power-law force; pow in double
        // and rounded once, as close to the plain version's powf as it gets
        f_pow = static_cast<float>(pow(static_cast<double>(w_H), static_cast<double>(1.0f + a_H))) *
                static_cast<float>(pow(static_cast<double>(nan_max(eta_1, 0.0f)),
                                       static_cast<double>(a_H - 1.0f)));
      }
      clk.mark(kPhExcitation);
    }

    // excitation RHS linearized at the iterate u_c (pallas_step.py:452-503),
    // shared by the sweeps and the GMRES rescue: this lane's rhs_u, and
    // the probe values.  `first` selects the bow's first-iterate probe
    // velocity (u1 - u2) / k.  Called by every thread (block reductions).
    auto exc_rhs = [&](float u_c, bool first, float& v_rel, float& F_H,
                       float& u_H) -> float {
      float rhs = rhs_u0;
      if constexpr (kExc) {
        float s[kSweepSums];
        int j = 0;
        if constexpr (kBow) {
          const float du = first ? u1 - u2 : u_c - u1;
          s[j++] = sRc[i] * (du / k - v_b);
        }
        if constexpr (kHammer) s[j++] = eps_prof * u_c;
        block_reduce<kSweepSums, false>(s, sred);
        if constexpr (kBow) {
          v_rel = s[0];
          const float phi = nan_sign(v_rel) * (phi1 + (1.0f - phi1) * expf(-phi0 * fabsf(v_rel)));
          const float G_B = -p.k2 * (sRc[i] / h_t) * (F_b * phi);
          rhs = rhs + bm * nan_to_num(G_B);
        }
        if constexpr (kHammer) {
          // inner fixed point on the string's scalars, at least one pass
          const float eps_u = s[kSweepSums - 1];
          float eta = eta_1 * hm;
#pragma unroll 1
          for (int ih = 0; ih < kHammerMaxIter; ++ih) {
            const float f_H = f_pow * (eta + eta_2) / 2.0f;
            F_H = eta_1 > 0.0f ? f_H : 0.0f;
            u_H = nan_max(2.0f * uH1 - uH2 - p.k2 * F_H - kHammerClamp, 0.0f) + kHammerClamp;
            const float eta_new = (u_H - eps_u) * hm;
            const float res = fabsf(eta - eta_new);
            eta = eta_new;
            if (!(res > tol_t)) break;
          }
          const float G_H = -p.k2 * eps_prof * (M_r * F_H);
          rhs = rhs + hm * nan_to_num(G_H);
        }
        clk.mark(kPhExcitation);
      }
      return rhs * live_t;
    };
    // K_tl of a z iterate: the l->t interpolation and -phi_pow Dxf(Lambda
    // Dxb .) through shared memory
    auto K_tl_of = [&](float z_in) -> float {
      sZc[i] = z_in;
      __syncthreads();
      const float izc = interp(sZc, lt);
      sIz1[i] = izc;
      __syncthreads();
      const float q = lam * ((izc - (i > 0 ? sIz1[i - 1] : 0.0f)) / h_t);
      sQ1[i] = q;
      __syncthreads();
      const float ktl = -phi_pow * (((i + 1 < W ? sQ1[i + 1] : 0.0f) - q) / h_t);
      clk.mark(kPhStencilLT);
      return ktl;
    };
    // the z half of a sweep: K_lt of the new u, then the PCR solve on l.
    // Every call follows a PCR solve on t, whose cycles its first mark takes
    auto z_solve = [&](float u_g, float rhs_zs) -> float {
      clk.mark(kPhPcrT);
      sUg[i] = u_g;
      __syncthreads();
      sP[i] = lam * ((u_g - (i > 0 ? sUg[i - 1] : 0.0f)) / h_t);
      __syncthreads();
      const float iu = interp(sP, tl);
      sIu[i] = iu;
      __syncthreads();
      const float K_lt = -phi_pow * (((i + 1 < W ? sIu[i + 1] : 0.0f) - iu) / h_l);
      clk.mark(kPhStencilTL);
      const float z_g = pcr(sub_l, diag_l, sup_l, -rhs_zs - K_lt, pcr_buf, p.levels);
      clk.mark(kPhPcrL);
      return z_g;
    };

    // ---- adaptive damped block Gauss-Seidel (pallas_step.py:505-578), or
    // the fixed schedule's plain sweeps (:517-519, :562-570) ----------------
    float u_c = u1, z_c = z1, omega = 1.0f, prev = INFINITY, scale_u = 0.0f;
    float v_rel = 0.0f, F_H = 0.0f, u_H = 0.0f;  // probe values of the last sweep
    bool hopeless = false;
    float K_tl = K_tl1;  // sweep 1 reuses the RHS pass's z interpolation
    for (int sweep = 0;; ++sweep) {
      if constexpr (kExc) rhs_u = exc_rhs(u_c, sweep == 0, v_rel, F_H, u_H);
      if (sweep > 0) K_tl = K_tl_of(z_c);
      const float u_g = pcr(sub_t, diag_t, sup_t, -rhs_u - K_tl, pcr_buf, p.levels);
      const float z_g = z_solve(u_g, rhs_z);
      clk.sweep();
      if constexpr (kFixed) {  // plain sweeps: no relaxation, reduction or exit test
        u_c = u_g;
        z_c = z_g;
        if (sweep + 1 >= p.coupling_fixed) break;
        continue;
      }

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
      clk.mark(kPhExit);
      if (!live_err || sweep + 1 >= p.coupling_iters) break;
    }

    // ---- untrusted exits (pallas_step.py:593-609): hopeless, non-finite or
    // above tolerance at the sweep cap; uniform across the block.  Poisoned,
    // or in the kGmres instance solved again by GMRES (:610-764).  The fixed
    // schedule has no exit test and trusts every exit ----------------------
    const bool bad =
        !kFixed && (hopeless || !(prev < INFINITY) || prev > inner_eps * scale_u);
    if constexpr (kGmres) {
      if (bad) {
        // GMRES(m) on (I - G) z = c from z = 0, G z the z of one RHS-free
        // sweep from z: one pass, or two with an excitation, the second's
        // RHS linearized at the first pass's u
        float u_lin = u1, z_sol = 0.0f, relres = 0.0f;
        for (int pass = 0; pass < (kExc ? 2 : 1); ++pass) {
          const float rhs_p = exc_rhs(u_lin, pass == 0, v_rel, F_H, u_H);
          const float cvec = z_solve(pcr(sub_t, diag_t, sup_t, -rhs_p - K_tl_of(0.0f),
                                         pcr_buf, p.levels),
                                     rhs_z);
          float r1[1] = {cvec * cvec};
          block_reduce<1, false>(r1, sred);
          const float beta = sqrtf(r1[0]);
          sV[i] = cvec * sdiv(1.0f, beta);
          float g_cur = beta, res = beta;
          int n_it = 0;
#pragma unroll 1
          for (int ii = 0; ii < kGmresM && res > 1e-6f * beta; ++ii) {
            const float vi = sV[ii * W + i];
            clk.mark(kPhGmres);
            const float gz = z_solve(pcr(sub_t, diag_t, sup_t, -0.0f - K_tl_of(vi),
                                         pcr_buf, p.levels),
                                     0.0f);
            float w = vi - gz;
            // modified Gram-Schmidt, one block reduction per basis row
#pragma unroll 1
            for (int j = 0; j <= ii; ++j) {
              const float vj = sV[j * W + i];
              float h[1] = {w * vj};
              block_reduce<1, false>(h, sred);
              w = w - h[0] * vj;
              if (i == 0) sH[j] = h[0];
            }
            float hn[1] = {w * w};
            block_reduce<1, false>(hn, sred);  // its barrier publishes sH
            const float hlast = sqrtf(hn[0]);
            sV[(ii + 1) * W + i] = w * sdiv(1.0f, hlast);
            // the earlier Givens rotations on the new column, then its own
            float a = sH[0];
#pragma unroll 1
            for (int j = 0; j < ii; ++j) {
              const float b = sH[j + 1], cj = sCs[j], sj = sSn[j];
              const float rj = cj * a + sj * b;
              a = -sj * a + cj * b;
              if (i == 0) sR[ii * kGmresM + j] = rj;
            }
            const float den = sqrtf(a * a + hlast * hlast);
            const float ci = sdiv(a, den), si = sdiv(hlast, den);
            if (i == 0) {
              sCs[ii] = ci;
              sSn[ii] = si;
              sR[ii * kGmresM + ii] = den;
              sG[ii] = ci * g_cur;
            }
            g_cur = -si * g_cur;
            res = fabsf(g_cur);
            ++n_it;
            clk.mark(kPhGmres);
          }
          __syncthreads();  // R, g and the last basis row
          if (i == 0) {  // back substitution on R y = g
            for (int i2 = n_it - 1; i2 >= 0; --i2) {
              float acc = sG[i2];
              for (int j = i2 + 1; j < n_it; ++j) acc = acc - sR[j * kGmresM + i2] * sY[j];
              sY[i2] = sdiv(acc, sR[i2 * kGmresM + i2]);
            }
          }
          __syncthreads();
          z_sol = 0.0f;
          for (int i2 = 0; i2 < n_it; ++i2) z_sol = z_sol + sY[i2] * sV[i2 * W + i];
          relres = sdiv(res, beta);
          clk.mark(kPhGmres);
          u_lin = pcr(sub_t, diag_t, sup_t, -rhs_p - K_tl_of(z_sol), pcr_buf, p.levels);
          clk.mark(kPhPcrT);
        }
        // accepted when the Krylov residual is small, else poisoned
        u_c = relres <= 1e-3f ? u_lin : NAN;
        z_c = z_sol;
        clk.mark(kPhGmres);
      }
    }
    // ---- Dirichlet rows (pallas_step.py:765-766); multiplying keeps a NaN
    // row NaN ----------------------------------------------------------------
    const float u_n = ((bad && !kGmres) ? NAN : u_c) * live_t * (i != 0 ? 1.0f : 0.0f) *
                      (itf != N_t ? 1.0f : 0.0f);
    const float z_n = z_c * live_l * (i != 0 ? 1.0f : 0.0f) * (itf != N_l ? 1.0f : 0.0f);

    // ---- readout (pallas_step.py:768-787) ---------------------------------
    if constexpr (kSurface) {
      float sums[2] = {u_n - su1[i], z_n - sz1[i]};
      block_reduce<2, false>(sums, sred);
      if (i == 0) {
        float w_out = 0.5f * h_t;
        if constexpr (kExc) w_out = w_out * (1.0f + hm + bm);
        p.uout[(size_t)b * T + t] = sums[0] * w_out / k;
        p.zout[(size_t)b * T + t] = sums[1] * w_out / k;
      }
    } else {
      // interpolated pickup, taps as masked sums
      const float u_ri = 1.0f + floorf(N_t * pos);
      const float z_ri = 1.0f + floorf(N_l * pos);
      float taps[4] = {(itf == u_ri ? 1.0f : 0.0f) * u_n, (itf == u_ri + 1.0f ? 1.0f : 0.0f) * u_n,
                       (itf == z_ri ? 1.0f : 0.0f) * z_n, (itf == z_ri + 1.0f ? 1.0f : 0.0f) * z_n};
      block_reduce<4, false>(taps, sred);
      if (i == 0) {
        const float u_rf = 1.0f + pos / h_t - u_ri, z_rf = 1.0f + pos / h_l - z_ri;
        p.uout[(size_t)b * T + t] = (1.0f - u_rf) * taps[0] + u_rf * taps[1];
        p.zout[(size_t)b * T + t] = (1.0f - z_rf) * taps[2] + z_rf * taps[3];
      }
    }
    if constexpr (kExc) {
      // probe traces and the uHs carry (pallas_step.py:791-802)
      if constexpr (!kHammer) {  // free ballistic hammer displacement
        u_H = nan_max(2.0f * uH1 - uH2 - kHammerClamp, 0.0f) + kHammerClamp;
      }
      if (i == 0) {
        p.v_r[(size_t)b * T + t] = v_rel;
        p.F_H[(size_t)b * T + t] = F_H;
        p.u_H[(size_t)b * T + t] = u_H;
      }
      uH2 = uH1;
      uH1 = u_H;
    }
    if (p.state_u != nullptr) {
      if (i < p.M_t) p.state_u[((size_t)t * p.B_rows + b) * p.ld_t + i] = u_n;
      if (i < p.M_l) p.state_z[((size_t)t * p.B_rows + b) * p.ld_l + i] = z_n;
    }
    // every read of the stored rows lies before block_reduce's barriers
    su2[i] = su1[i];
    su1[i] = u_n;
    sz2[i] = sz1[i];
    sz1[i] = z_n;
    __syncthreads();
    clk.mark(kPhReadout);
  }

  if (i < p.M_t) {
    p.u1_out[(size_t)b * p.ld_t + i] = su1[i];
    p.u2_out[(size_t)b * p.ld_t + i] = su2[i];
  }
  if (i < p.M_l) {
    p.z1_out[(size_t)b * p.ld_l + i] = sz1[i];
    p.z2_out[(size_t)b * p.ld_l + i] = sz2[i];
  }
#ifdef STRING_STEP_CLOCKS
  __syncthreads();  // thread 0's last mark
  if (i < kClockSlots) p.clocks[(size_t)b * kClockSlots + i] = clk.acc[i];
#endif
}

template <bool kBow, bool kHammer, bool kSurface, bool kGmres, bool kMms = false,
          bool kFixed = false>
cudaError_t launch(const Params& p, int W, cudaStream_t stream) {
#ifdef STRING_STEP_CLOCKS
  const size_t smem = clock_offset(W, kBow, kGmres) * sizeof(float) +
                      kClockSlots * sizeof(long long);
#else
  const size_t smem = shared_floats(W, kBow, kGmres) * sizeof(float);
#endif
  auto kernel = string_step_kernel<kBow, kHammer, kSurface, kGmres, kMms, kFixed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<p.B, W, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch_checked(const LaunchArgs* a, long long* clocks, void* stream) {
  if (a == nullptr || a->struct_size != static_cast<int>(sizeof(LaunchArgs))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = a->W;
  const bool has_bow = a->has_bow != 0, has_hammer = a->has_hammer != 0;
  const bool surface = a->surface_integral != 0;
  const bool missing =
      a->f0 == nullptr || a->kappa == nullptr || a->alpha == nullptr || a->t60 == nullptr ||
      a->u1 == nullptr || a->u2 == nullptr || a->z1 == nullptr || a->z2 == nullptr ||
      a->uout == nullptr || a->zout == nullptr || a->u1_out == nullptr ||
      a->u2_out == nullptr || a->z1_out == nullptr || a->z2_out == nullptr ||
      (!surface && a->pos == nullptr) ||
      (has_bow && (a->x_b == nullptr || a->v_b == nullptr || a->F_b == nullptr ||
                   a->wid == nullptr || a->phi_0 == nullptr || a->phi_1 == nullptr ||
                   a->bmask == nullptr)) ||
      (has_hammer && (a->x_H == nullptr || a->w_H == nullptr || a->M_r == nullptr ||
                      a->alpha_H == nullptr || a->hmask == nullptr)) ||
      ((has_bow || has_hammer) && (a->uH1 == nullptr || a->uH2 == nullptr ||
                                   a->v_r == nullptr || a->F_H == nullptr ||
                                   a->u_H == nullptr));
  if (missing || W < 32 || W > 1024 || W % 32 != 0 || W < a->M_t || W < a->M_l ||
      a->B < 1 || a->T < 1 || a->coupling_iters < 1 || a->M_t_sem < 1 ||
      a->ld_t < a->M_t || a->ld_l < a->M_l ||
      (a->rows == nullptr ? a->B_rows != a->B : a->B_rows < 1) ||
      (a->manufactured != 0 && a->p_a == nullptr) || a->coupling_fixed < 0 ||
      // MMS and the fixed schedule: plucked strings only, not together,
      // and the fixed schedule without the rescue
      ((a->manufactured != 0 || a->coupling_fixed > 0) && (has_bow || has_hammer)) ||
      (a->manufactured != 0 && a->coupling_fixed > 0) ||
      (a->coupling_fixed > 0 && a->gmres != 0) ||
      (a->state_u == nullptr) != (a->state_z == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  static_cast<LaunchArgs&>(p) = *a;
  p.clocks = clocks;
  p.levels = 0;
  while ((1 << p.levels) < W) ++p.levels;
  const double k = a->k, theta = a->theta;
  p.k_f = static_cast<float>(k);
  p.k2 = static_cast<float>(k * k);
  p.k4 = static_cast<float>(pow(k, 4.0));
  p.theta_f = static_cast<float>(theta);
  p.c_half = static_cast<float>((1.0 - theta) * 0.5);
  p.c_a0 = static_cast<float>((1.0 - theta) / 2.0);
  p.two_t = static_cast<float>(2.0 * theta - 1.0);
  p.two_two_t = static_cast<float>(2.0 * (2.0 * theta - 1.0));
  p.lambda_f = static_cast<float>(a->lambda_c);
  p.two_pi = static_cast<float>(2.0 * M_PI);
  p.ln10_6 = static_cast<float>(6.0 * log(10.0));
  p.inner_eps = static_cast<float>(100.0 * 1.1920928955078125e-07);  // 100 FLT_EPSILON
  p.M_t_sem_f = static_cast<float>(a->M_t_sem);
  p.pi_f = static_cast<float>(M_PI);
  p.mu2 = static_cast<float>(M_PI * M_PI);
  p.two_mu2 = static_cast<float>(2.0 * (M_PI * M_PI));

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->coupling_fixed > 0) {
    err = surface ? launch<false, false, true, false, false, true>(p, W, s)
                  : launch<false, false, false, false, false, true>(p, W, s);
    return static_cast<int>(err);
  }
  if (a->manufactured != 0) {
    if (a->gmres != 0) {
      err = surface ? launch<false, false, true, true, true>(p, W, s)
                    : launch<false, false, false, true, true>(p, W, s);
    } else {
      err = surface ? launch<false, false, true, false, true>(p, W, s)
                    : launch<false, false, false, false, true>(p, W, s);
    }
    return static_cast<int>(err);
  }
  const int spec = (a->gmres != 0 ? 8 : 0) | (has_bow ? 4 : 0) | (has_hammer ? 2 : 0) |
                   (surface ? 1 : 0);
  switch (spec) {
    case 0: err = launch<false, false, false, false>(p, W, s); break;
    case 1: err = launch<false, false, true, false>(p, W, s); break;
    case 2: err = launch<false, true, false, false>(p, W, s); break;
    case 3: err = launch<false, true, true, false>(p, W, s); break;
    case 4: err = launch<true, false, false, false>(p, W, s); break;
    case 5: err = launch<true, false, true, false>(p, W, s); break;
    case 6: err = launch<true, true, false, false>(p, W, s); break;
    case 7: err = launch<true, true, true, false>(p, W, s); break;
    case 8: err = launch<false, false, false, true>(p, W, s); break;
    case 9: err = launch<false, false, true, true>(p, W, s); break;
    case 10: err = launch<false, true, false, true>(p, W, s); break;
    case 11: err = launch<false, true, true, true>(p, W, s); break;
    case 12: err = launch<true, false, false, true>(p, W, s); break;
    case 13: err = launch<true, false, true, true>(p, W, s); break;
    case 14: err = launch<true, true, false, true>(p, W, s); break;
    default: err = launch<true, true, true, true>(p, W, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int string_step_launch(const LaunchArgs* a, void* stream) {
#ifdef STRING_STEP_CLOCKS
  return static_cast<int>(cudaErrorInvalidValue);  // this build takes a clocks buffer
#else
  return launch_checked(a, nullptr, stream);
#endif
}

#ifdef STRING_STEP_CLOCKS
// The instrumented build's entry point: ``clocks`` is a (B_rows,
// kClockSlots) int64 buffer on the device, indexed by batch row.
extern "C" int string_step_launch_clocks(const LaunchArgs* a, long long* clocks,
                                         void* stream) {
  if (clocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_checked(a, clocks, stream);
}

extern "C" int string_step_clock_phases() { return kClockPhases; }
#endif
