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
// ops/string_kernel.py::string_chunked_reference, whose tridiagonal solve is
// ops/tridiag.py::partition_factor / partition_solve.
//
// What bounds it on this card: latency and issue.  A string's step is one
// dependent chain (the RHS, 1-3 Gauss-Seidel sweeps of two tridiagonal
// solves, their stencils and exit test, the readout), and device-memory
// traffic is small: the f0 column (and the four bow signals) in, the
// readouts and probe traces out and, with collect_state, M_t + M_l floats of
// state per string and step, written coalesced.  So the design shortens the
// chain and keeps the row work off it.
//
// Design: one warpgroup per string (a CTA of 4 warps, 128 threads; the
// hardware packs several onto an SM once B passes the SM count), and no
// __syncthreads: the warpgroup meets at its named barrier (bar.sync 1, 128).
// The string's rows live in shared memory: u^{n-1}, u^{n-2}, z^{n-1},
// z^{n-2}, the iterates, the per-step stencil operands and the interpolation
// tables, W floats each (W = max(M_t, M_l) rounded up to whole warps).  The
// row passes (the RHS, the stencils, the relaxation, the readout) run
// strided over the warpgroup's threads; their divisions by the grid
// spacings take the spacings' reciprocals, folded once per step, and one
// Markstein correction each (Div: the IEEE quotient, bit for bit).  Each
// tridiagonal solve is partitioned and runs on warp 0: the string's live
// rows [0, n) (n from its own grid size at that step, never from W, so a
// string's result does not depend on its bucket) are cut into 32 contiguous
// blocks, one per lane; each lane eliminates its block down to its first and
// last row, the 64-row reduced system is solved by six PCR levels whose
// neighbours come by shuffles, and each lane substitutes back.  The matrices
// depend on u^{n-1} alone, so each step factors both systems once, the t
// system on warp 0 and the l system on warp 1 side by side (the local
// elimination coefficients and the reduced system's (a, c, rD) per level in
// shared memory), and every later solve of the step, each sweep's and each
// GMRES matvec's, runs the right-hand side only: a forward and a backward
// pass over the lane's rows, six shuffle levels, and the back substitution.
// Padded rows (i >= n) are identity rows and keep their right-hand side.
// The solve has no pivoting: like PCR it relies on the systems' diagonal
// dominance.  Reductions (the sweep residuals, max|u|, the readouts, the
// bow's and hammer's sums, the rescue's Gram-Schmidt products) are warp
// butterflies whose four partials every thread folds in warp order, so every
// thread holds the same result and every exit decision is uniform; the
// bow's two sums, which feed its friction law, and the rescue's inner
// products accumulate in double.  The
// per-string excitation scalars (the hammer's inner fixed point of at most
// 40 iterations, the friction law, the hammer displacement carry) are
// computed by every thread alike from the reduced values.  The step's f0
// and bow signals are loaded one step ahead.
//
// Earlier designs (PERF.md): one CTA per string with one thread per grid
// point and a 9-level PCR behind __syncthreads per solve ran ~35,600 cycles
// per string-step, half of them PCR; a few-barrier rework bit for bit with
// it was 8-25% slower, the cost being the dependent chain, not the barriers;
// one warp per string with this solve ran ~96,300, its row passes bound by
// one scheduler's issue and by their IEEE divisions by the grid spacings
// (~10 dependent instructions each); a warpgroup with those divisions
// ~41,800, with products by the reciprocals ~22,500 (but those round
// otherwise than the plain version and the JAX kernel).  This design runs
// ~26,300.

// The GMRES rescue (kGmres; pallas_step.py:579-764): a string whose sweeps
// exit untrusted (hopeless, non-finite, or above tolerance at the cap)
// solves the step's coupled system again by GMRES(16) on the z fixed point
// (I - G) z = c, G z the z of one RHS-free sweep from z: the matvec is two
// factored solves and the interpolations, the Krylov basis lives in shared
// memory (17 W floats after the row arrays), modified Gram-Schmidt takes one
// group reduction per basis row, and every thread runs the Givens recurrence
// alike from the reduced values while thread 0 keeps R, g, cs and sn in
// shared memory and back-substitutes.  It is compiled out of the first pass's
// instances, whose code it would slow.
//
// Width buckets (replaces pallas_step.py::string_chunked_bucketed and
// _build_bucketed_fn): a launch may run a subset of a batch at a narrower
// width.  `rows` maps each CTA to its row of the full batch, and the row
// strides ld_t / ld_l and the state's batch size B_rows are the full
// batch's, so each CTA reads its string's inputs and writes its outputs,
// traces and state rows in place: no gather or scatter copy of the (T, B, M)
// field.  M_t / M_l are the rows this launch reads and writes; M_t_sem is
// the allocation's M_t, which sets the z live-row count and the bow's
// spatial axis.  ops/string_kernel.py launches one group per stream.
//
// MMS forcing (manufactured, pallas_step.py:392-412): the closed-form
// source of the verification runs is subtracted from the u and z RHS before
// the z live-row mask, u at its grid's x = (clip(2i/N_t, 0, 2) - 1)/2 and z
// at x = 1/2, at time (n - [mms_centered]) k with n the step's index counted
// from 2 at the launch's first step, as the JAX kernel counts it.  p_a is
// read through the CTA->row map.  MMS and the fixed schedule are
// compile-time parameters of the pluck instances only (no path runs either
// with a bow or a hammer, and the launcher refuses that combination).
//
// The fixed schedule (coupling_fixed > 0, pallas_step.py:517-519, :562-570):
// exactly that many plain sweeps (omega 1, the first reusing the RHS pass's
// z interpolation), with no reductions and no exit test, so no exit is
// untrusted: no poison and no rescue.
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
// `rows`, B_rows = B, ld_t = M_t and ld_l = M_l.  W is the row width.
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

// The kernel's parameters: the launch arguments and constants folded in
// double on the host, then rounded to float, as the JAX kernel folds its
// Python-float constants.
struct Params : LaunchArgs {
  long long* clocks;  // the instrumented build's (B_rows, kClockSlots) counts
  float k_f, k2, k4, theta_f, c_half, c_a0, two_t, two_two_t, lambda_f, two_pi;
  float ln10_6, inner_eps, M_t_sem_f;
  float pi_f, mu2, two_mu2;  // the MMS forcing's pi, pi^2 and 2 pi^2
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kWarps = 4;  // one warpgroup per string
constexpr int kThreads = kWarps * kLanes;
// the group reductions' two alternating buffers of up to 4 values (float
// or double) per warp
constexpr int kRedFloats = 2 * 4 * kWarps * 2;
constexpr float kOmegaFloor = 0.0625f;
constexpr float kHammerClamp = -0.01f;  // M_HD_CLAMP, pallas_step.py:46
constexpr int kHammerMaxIter = 40;      // KernelConsts.hammer_max_iter
constexpr int kRowArrays = 20;  // W-wide shared arrays, see the layout below
// the partitioned solve: per system five per-row factor arrays (P, Q, G,
// Aa, Gg, each lane's slots r at r * 32 + lane), and the reduced system's
// (a, c, rD) of a lane's first and last row for each of its six PCR levels
constexpr int kFactorArrays = 5;
constexpr int kLevels = 6;  // ceil(log2(2 * kLanes))
constexpr int kLevelFloats = kLevels * 6 * kLanes;
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
  kPhRhs,        // the RHS passes and the interpolation tables
  kPhFactorT,    // factoring the t system
  kPhSolveT,     // the t solves (right-hand side only)
  kPhStencilTL,  // the t->l stencil: K_lt of the u iterate
  kPhFactorL,    // factoring the l system
  kPhSolveL,     // the l solves
  kPhStencilLT,  // the l->t stencil: K_tl of a z iterate, and the t RHS
  kPhExit,       // relaxation and the exit reduction
  kPhReadout,    // readout, state write, the carry
  kPhExcitation, // the bow's and hammer's reductions and scalars
  kPhGmres,      // the rescue, apart from its solves and stencils
  kClockPhases
};
constexpr int kClockSlots = kClockPhases + 1;

// rows of a lane's factor slots: every block holds at most
// max(ceil(W / 32), 3) rows
__host__ __device__ constexpr int factor_stride(int W) { return W > 96 ? W : 96; }

// floats of dynamic shared memory the kernel lays out (string_step_kernel),
// and the instrumented build's counters after them, 8-byte aligned
__host__ __device__ constexpr size_t shared_floats(int W, bool bow, bool gmres) {
  return static_cast<size_t>(kRowArrays + (bow ? 1 : 0)) * W + kRedFloats +
         2 * (static_cast<size_t>(kFactorArrays) * factor_stride(W) + kLevelFloats) +
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

// linear resample index from n_in to n_out points (pallas_step.py:306-313):
// the low source row and the fraction; the high row and the mask follow
__device__ __forceinline__ void interp_idx(float itf, float n_in, float n_out, int W,
                                           int& lo_out, float& frac) {
  const float denom = fmaxf(n_out - 1.0f, 1.0f);
  const float posn = fminf(fmaxf(itf * (n_in - 1.0f) / denom, 0.0f), n_in - 1.0f);
  const float lo = floorf(posn);
  frac = posn - lo;
  lo_out = min(max(static_cast<int>(lo), 0), W - 1);
}

// src resampled at row i of the target grid from the table (lo, frac)
__device__ __forceinline__ float interp(const float* src, const int* lo_t, const float* fr_t,
                                        int i, float n_in, float n_out) {
  const int lo = lo_t[i];
  const int hi = min(lo + 1, max(static_cast<int>(n_in) - 1, 0));
  const float frac = fr_t[i];
  return (src[lo] * (1.0f - frac) + src[hi] * frac) *
         (static_cast<float>(i) < n_out ? 1.0f : 0.0f);
}

// Warp butterfly of N values per lane: every lane gets the same result.
template <class T, int N, bool kMax>
__device__ __forceinline__ void warp_reduce(T (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T o = __shfl_xor_sync(kFull, v[j], off);
      if constexpr (kMax) {
        v[j] = nan_max(v[j], o);
      } else {
        v[j] = v[j] + o;
      }
    }
  }
}

// Division by one of a step's grid spacings (or their squares): x / y, the
// IEEE quotient bit for bit, from y's correctly rounded reciprocal by one
// product and one Markstein correction, where the division routine takes
// about ten dependent instructions and a branch.  Exact for a normal y and
// a normal quotient; where the product is zero, infinite or NaN, or y is
// infinite, the product is the quotient already.
struct Div {
  float y, ry;
  bool finite_y;
  __device__ __forceinline__ explicit Div(float y_)
      : y(y_), ry(1.0f / y_), finite_y(fabsf(y_) < INFINITY) {}
  __device__ __forceinline__ float operator()(float x) const {
    const float q0 = x * ry;
    const float q = fmaf(fmaf(-y, q0, x), ry, q0);
    return (x != 0.0f && fabsf(q0) < INFINITY && finite_y) ? q : q0;
  }
};

// The string's named barrier: its warpgroup's threads, and no other CTA's.
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// Reduction of N <= 4 values per thread over the warpgroup: warp
// butterflies, then every thread folds the warps' partials in warp order,
// so every thread holds the same result.  The partials alternate between
// two buffers (par), so one barrier per reduction suffices.
template <int N, bool kMax, class T>
__device__ __forceinline__ void group_reduce(T (&v)[N], float* red, int& par) {
  static_assert(N <= 4, "group_reduce holds 4 values per warp");
  warp_reduce<T, N, kMax>(v);
  T* buf = reinterpret_cast<T*>(reinterpret_cast<double*>(red) + par * 4 * kWarps);
  par ^= 1;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) buf[j * kWarps + (threadIdx.x >> 5)] = v[j];
  }
  group_sync();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T r = buf[j * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if constexpr (kMax) {
        r = nan_max(r, buf[j * kWarps + w]);
      } else {
        r = r + buf[j * kWarps + w];
      }
    }
    v[j] = r;
  }
}

// ---- the partitioned tridiagonal solve (ops/tridiag.py::partition_factor,
// partition_solve) ------------------------------------------------------------

// rows of a system with n live rows: the live count of a grid of live size
// n_f (NaN: none; past W: W)
__device__ __forceinline__ int live_rows(float n_f, int W) {
  if (n_f != n_f) return 0;
  return static_cast<int>(fminf(fmaxf(ceilf(n_f), 0.0f), static_cast<float>(W)));
}

// a lane's block [s, s + m) of the live rows: P = min(32, max(1, n / 2))
// blocks of n / P rows, the first n % P one longer; lanes from P hold none
struct Block {
  int s, m;
};
__device__ __forceinline__ Block block_of(int n, int lane) {
  const int P = min(kLanes, max(1, n >> 1));
  if (lane >= P) return {n, 0};
  const int base = n / P, extra = n - base * P;
  return {lane * base + min(lane, extra), base + (lane < extra ? 1 : 0)};
}

// the neighbours at distance 2^lvl in the 64-row reduced system of a lane's
// first (row 2 lane) and last (row 2 lane + 1) value; zero outside it
__device__ __forceinline__ void reduced_nb(int lvl, int lane, float vF, float vL, float& Fm,
                                           float& Fp, float& Lm, float& Lp) {
  if (lvl == 0) {
    const float up = __shfl_up_sync(kFull, vL, 1);
    const float dn = __shfl_down_sync(kFull, vF, 1);
    Fm = lane >= 1 ? up : 0.0f;
    Fp = vL;
    Lm = vF;
    Lp = lane + 1 < kLanes ? dn : 0.0f;
  } else {
    const int t = 1 << (lvl - 1);
    const float fu = __shfl_up_sync(kFull, vF, t), fd = __shfl_down_sync(kFull, vF, t);
    const float lu = __shfl_up_sync(kFull, vL, t), ld = __shfl_down_sync(kFull, vL, t);
    Fm = lane >= t ? fu : 0.0f;
    Fp = lane + t < kLanes ? fd : 0.0f;
    Lm = lane >= t ? lu : 0.0f;
    Lp = lane + t < kLanes ? ld : 0.0f;
  }
}

// Factor the system whose row i, scaled to unit diagonal, is coef(i, a, c,
// rb) (a = sub / diag, c = sup / diag, rb = 1 / diag), on the lane's block
// bk of its live rows, into F (kFactorArrays arrays of stride fs) and L (kLevelFloats).
// Per block [s, e]: the forward pass from row
// s + 2 eliminates each row's lower neighbour (alpha couples x_s, gamma
// x_{i+1}); the backward pass from e - 1 writes rows s + 1 .. e - 1 in x_s
// and x_e (Aa, Gg) and row s in x_{s-1} and x_e.  Called by the whole warp.
template <class Coef>
__device__ __forceinline__ void factor(Coef coef, Block bk, float* __restrict__ F,
                                       float* __restrict__ L, int fs, int lane) {
  float* __restrict__ fP = F;
  float* __restrict__ fQ = F + fs;
  float* __restrict__ fG = F + 2 * fs;
  float* __restrict__ fA = F + 3 * fs;
  float* __restrict__ fGg = F + 4 * fs;
  const int s = bk.s, m = bk.m;
  float aF = 0.0f, cF = 0.0f, aL = 0.0f, cL = 0.0f;
  if (m >= 1) {
    float a0, c0, rb0;
    coef(s, a0, c0, rb0);
    if (m == 1) {  // a lone row: both reduced rows carry it, uncoupled
      fP[lane] = rb0;
      aF = a0;
      cL = c0;
    } else {
      float alpha, gamma, rb1;
      coef(s + 1, alpha, gamma, rb1);
      fP[kLanes + lane] = rb1;
      fA[kLanes + lane] = alpha;
      fG[kLanes + lane] = gamma;
#pragma unroll 2
      for (int j = 2; j < m; ++j) {
        float a, c, rb;
        coef(s + j, a, c, rb);
        const float r = 1.0f / (1.0f - a * gamma);
        alpha = -(a * alpha) * r;
        gamma = c * r;
        const int o = j * kLanes + lane;
        fP[o] = rb * r;
        fQ[o] = a * r;
        fA[o] = alpha;
        fG[o] = gamma;
      }
      aL = alpha;
      cL = gamma;
      if (m == 2) {
        fP[lane] = rb0;
        aF = a0;
        cF = c0;
      } else {
        float Aa = fA[(m - 2) * kLanes + lane], Gg = fG[(m - 2) * kLanes + lane];
        fGg[(m - 2) * kLanes + lane] = Gg;
        for (int j = m - 3; j >= 1; --j) {
          const int o = j * kLanes + lane;
          const float g = fG[o];
          Aa = fA[o] - g * Aa;
          Gg = -(g * Gg);
          fA[o] = Aa;
          fGg[o] = Gg;
        }
        const float rs = 1.0f / (1.0f - c0 * Aa);
        fP[lane] = rb0 * rs;
        fQ[lane] = c0 * rs;
        aF = a0 * rs;
        cF = -(c0 * Gg) * rs;
      }
    }
  }
  // the reduced system's PCR levels: (a, c, rD) of both rows per level
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    float aFm, aFp, aLm, aLp, cFm, cFp, cLm, cLp;
    reduced_nb(lvl, lane, aF, aL, aFm, aFp, aLm, aLp);
    reduced_nb(lvl, lane, cF, cL, cFm, cFp, cLm, cLp);
    const float rF = 1.0f / (1.0f - aF * cFm - cF * aFp);
    const float rL = 1.0f / (1.0f - aL * cLm - cL * aLp);
    float* Lv = L + lvl * 6 * kLanes + lane;
    Lv[0] = aF;
    Lv[kLanes] = cF;
    Lv[2 * kLanes] = rF;
    Lv[3 * kLanes] = aL;
    Lv[4 * kLanes] = cL;
    Lv[5 * kLanes] = rL;
    const float naF = -(aF * aFm) * rF, ncF = -(cF * cFp) * rF;
    const float naL = -(aL * aLm) * rL, ncL = -(cL * cLp) * rL;
    aF = naF;
    cF = ncF;
    aL = naL;
    cL = ncL;
  }
}

// Solve the factored system for the right-hand side in buf, in place, on
// the lane's block bk: the
// forward pass (delta_i = rhs_i P_i - Q_i delta_{i-1}), the backward pass
// (delta'_i = delta_i - G_i delta'_{i+1}), the reduced system's six levels
// ((d - a d_m - c d_p) rD, neighbours by shuffles), then each inner row
// from its block's first and last (delta'_i - Aa_i x_s - Gg_i x_e).  Rows
// past n keep their right-hand side: the solution of an identity row.
// Called by the whole warp; reads and writes the lane's own block only.
__device__ __forceinline__ void solve(float* __restrict__ buf, Block bk, const float* __restrict__ F,
                                      const float* __restrict__ L, int fs, int lane) {
  const float* __restrict__ fP = F;
  const float* __restrict__ fQ = F + fs;
  const float* __restrict__ fG = F + 2 * fs;
  const float* __restrict__ fA = F + 3 * fs;
  const float* __restrict__ fGg = F + 4 * fs;
  const int s = bk.s, m = bk.m;
  float dF = 0.0f, dL = 0.0f;
  if (m >= 1) {
    const float d0 = buf[s] * fP[lane];
    dF = d0;
    dL = d0;
    if (m >= 2) {
      float delta = buf[s + 1] * fP[kLanes + lane];
      buf[s + 1] = delta;
#pragma unroll 4
      for (int j = 2; j < m; ++j) {
        const int o = j * kLanes + lane;
        delta = buf[s + j] * fP[o] - fQ[o] * delta;
        buf[s + j] = delta;
      }
      dL = delta;
      if (m >= 3) {
        float dp = buf[s + m - 2];
#pragma unroll 4
        for (int j = m - 3; j >= 1; --j) {
          dp = buf[s + j] - fG[j * kLanes + lane] * dp;
          buf[s + j] = dp;
        }
        dF = d0 - fQ[lane] * dp;
      }
    }
  }
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    float Fm, Fp, Lm, Lp;
    reduced_nb(lvl, lane, dF, dL, Fm, Fp, Lm, Lp);
    const float* Lv = L + lvl * 6 * kLanes + lane;
    const float nF = (dF - Lv[0] * Fm - Lv[kLanes] * Fp) * Lv[2 * kLanes];
    const float nL = (dL - Lv[3 * kLanes] * Lm - Lv[4 * kLanes] * Lp) * Lv[5 * kLanes];
    dF = nF;
    dL = nL;
  }
  if (m >= 1) {
    buf[s] = dF;
    if (m >= 2) buf[s + m - 1] = dL;
#pragma unroll 4
    for (int j = 1; j < m - 1; ++j) {
      const int o = j * kLanes + lane;
      buf[s + j] = (buf[s + j] - fA[o] * dF) - fGg[o] * dL;
    }
  }
}

template <bool kBow, bool kHammer, bool kSurface, bool kGmres, bool kMms, bool kFixed>
__global__ void __launch_bounds__(kThreads) string_step_kernel(const Params p) {
  constexpr bool kExc = kBow || kHammer;
  extern __shared__ float sm[];
  const int W = p.W, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = p.rows != nullptr ? p.rows[blockIdx.x] : blockIdx.x;  // batch row
  const int T = p.T;
  const int fs = factor_stride(W);

  // shared-memory layout, W floats each
  float* __restrict__ su1 = sm;        // stored state, row n-1 (unmasked)
  float* __restrict__ su2 = sm + W;    // row n-2
  float* __restrict__ sz1 = sm + 2 * W;
  float* __restrict__ sz2 = sm + 3 * W;
  float* __restrict__ sLam = sm + 4 * W;  // Lambda = Dxb u1
  float* __restrict__ sRu0 = sm + 5 * W;  // the iterate-independent u RHS (before the live mask)
  float* __restrict__ sRz = sm + 6 * W;   // the z RHS, masked
  float* __restrict__ sUc = sm + 7 * W;   // the iterates
  float* __restrict__ sZc = sm + 8 * W;
  float* __restrict__ sUg = sm + 9 * W;   // the t solve's right-hand side, then its solution
  float* __restrict__ sZg = sm + 10 * W;  // the l solve's
  // stencil operands; pass 2 leaves the t system's scaled rows in sT3,
  // sUg and sZg for the factor
  float* __restrict__ sT0 = sm + 11 * W;
  float* __restrict__ sT1 = sm + 12 * W;
  float* __restrict__ sT2 = sm + 13 * W;
  float* __restrict__ sT3 = sm + 14 * W;
  float* __restrict__ sKtl = sm + 15 * W;  // K_tl of z^{n-1}, sweep 1's
  int* __restrict__ ltLo = reinterpret_cast<int*>(sm + 16 * W);  // z (l-grid) -> t-grid table
  float* ltFr = sm + 17 * W;
  int* __restrict__ tlLo = reinterpret_cast<int*>(sm + 18 * W);  // t-grid -> l-grid table
  float* tlFr = sm + 19 * W;
  float* __restrict__ sRc = sm + kRowArrays * W;  // bow force profile (bow only)
  float* __restrict__ sRed = sm + (kRowArrays + (kBow ? 1 : 0)) * W;  // group_reduce's buffers
  int red_par = 0;
  float* __restrict__ fT = sRed + kRedFloats;  // the t system's factors
  float* __restrict__ lT = fT + kFactorArrays * fs;
  float* __restrict__ fL = lT + kLevelFloats;  // the l system's
  float* __restrict__ lL = fL + kFactorArrays * fs;
  // the GMRES rescue (kGmres only): Krylov basis rows V_0..V_m, then R
  // (column i at i*m), g, cs, sn, the Hessenberg column and y, all written
  // by thread 0 and read after a barrier
  float* __restrict__ sV = lL + kLevelFloats;
  float* __restrict__ sR = sV + kGmresRows * W;
  float* __restrict__ sG = sR + kGmresM * kGmresM;
  float* __restrict__ sCs = sG + kGmresRows;
  float* __restrict__ sSn = sCs + kGmresM;
  float* __restrict__ sH = sSn + kGmresM;
  float* __restrict__ sY = sH + kGmresRows;

  for (int i = tid; i < W; i += kThreads) {
    su1[i] = i < p.M_t ? p.u1[(size_t)b * p.ld_t + i] : 0.0f;
    su2[i] = i < p.M_t ? p.u2[(size_t)b * p.ld_t + i] : 0.0f;
    sz1[i] = i < p.M_l ? p.z1[(size_t)b * p.ld_l + i] : 0.0f;
    sz2[i] = i < p.M_l ? p.z2[(size_t)b * p.ld_l + i] : 0.0f;
  }
  const float kappa = p.kappa[b], alpha = p.alpha[b];
  const float freq1 = p.t60[4 * b], time1 = p.t60[4 * b + 1];
  const float freq2 = p.t60[4 * b + 2], time2 = p.t60[4 * b + 3];
  const float k = p.k_f, theta = p.theta_f, inner_eps = p.inner_eps;
  const float pos = kSurface ? 0.0f : p.pos[b];
  // per-string excitation constants and the hammer displacement carry
  // (uH1 the newest, uH2 the one before), uniform across the CTA
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
  if (tid < kClockSlots) clk.acc[tid] = 0;
  clk.last = clock64();
#endif
  group_sync();

  // the step's f0 (and bow signals), loaded one step ahead
  float f0_next = p.f0[(size_t)b * T];
  float bow_next[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // x_b, v_b, F_b, wid
  auto load_bow = [&](int t) {
    if constexpr (kBow) {
      const size_t bt = (size_t)b * T + t;
      bow_next[0] = p.x_b[bt];
      bow_next[1] = p.v_b[bt];
      bow_next[2] = p.F_b[bt];
      bow_next[3] = p.wid[bt];
    }
  };
  load_bow(0);
  for (int t = 0; t < T; ++t) {
    // ---- per-step grid and loss terms (pallas_step.py:248-291) ----------
    const float gamma = 2.0f * f0_next;
    const float x_bt = bow_next[0], v_bt = bow_next[1], F_bt = bow_next[2], wid_t = bow_next[3];
    if (t + 1 < T) {
      f0_next = p.f0[(size_t)b * T + t + 1];
      load_bow(t + 1);
    }
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
    // ln(10^6) / (zeta1 - zeta2), as the plain version forms a number over a
    // tensor: the reciprocal, then the product
    const float scale = (1.0f / (zeta1 - zeta2)) * p.ln10_6;
    const float sig0 = scale * (lossy ? -zeta2 / st1 + zeta1 / st2 : 0.0f);
    const float sig1 = scale * (lossy ? 1.0f / st1 - 1.0f / st2 : 0.0f);
    const int rows_t = live_rows(n_t, W), rows_l = live_rows(n_l, W);
    const Block blk_t = block_of(rows_t, lane), blk_l = block_of(rows_l, lane);
    clk.mark(kPhStart);

    // masked reads of the stored rows; zero outside [0, W)
    auto U1 = [&](int j) { return (j >= 0 && j < W) ? su1[j] * (static_cast<float>(j) < n_t ? 1.0f : 0.0f) : 0.0f; };
    auto U2 = [&](int j) { return (j >= 0 && j < W) ? su2[j] * (static_cast<float>(j) < n_t ? 1.0f : 0.0f) : 0.0f; };
    auto Z1 = [&](int j) { return (j >= 0 && j < W) ? sz1[j] * (static_cast<float>(j) < n_l ? 1.0f : 0.0f) : 0.0f; };
    auto Z2 = [&](int j) { return (j >= 0 && j < W) ? sz2[j] * (static_cast<float>(j) < n_l ? 1.0f : 0.0f) : 0.0f; };
    auto live_t = [&](int i) { return static_cast<float>(i) < n_t ? 1.0f : 0.0f; };
    auto at = [&](const float* a, int j) { return (j >= 0 && j < W) ? a[j] : 0.0f; };

    const float gamma_k = g2 * p.k2;
    const float phi_pow = gamma_k * (alpha * alpha - 1.0f) / 4.0f;
    const float hh_t = h_t * h_t, hh_l = h_l * h_l;
    const Div d_t(h_t), d_tt(hh_t), d_t4(hh_t * hh_t), d_l(h_l), d_ll(hh_l);

    // ---- RHS pass 1: Lambda, the interpolation tables, z^{n-1}, z^{n-2}
    // on the t-grid and Lambda Dxb u^{n-2} (pallas_step.py:294-330) ---------
#pragma unroll 2
    for (int i = tid; i < W; i += kThreads) {
      const float itf = static_cast<float>(i);
      const float lam = d_t(U1(i) - U1(i - 1));
      sLam[i] = lam;
      sT2[i] = lam * d_t(U2(i) - U2(i - 1));
      int lo;
      float fr;
      interp_idx(itf, n_t, n_l, W, lo, fr);
      tlLo[i] = lo;
      tlFr[i] = fr;
      interp_idx(itf, n_l, n_t, W, lo, fr);
      ltLo[i] = lo;
      ltFr[i] = fr;
      // interpolation reads stay inside the live source region (lo, hi <
      // n_in), where the masked and the stored values coincide
      sT0[i] = interp(sz1, ltLo, ltFr, i, n_l, n_t);
      sT1[i] = interp(sz2, ltLo, ltFr, i, n_l, n_t);
    }
    group_sync();

    // pass 2: K_tl w = -phi_pow Dxf(Lambda Dxb w) of both z rows, K_lt w =
    // -phi_pow Dxf w of the interpolated Lambda Dxb u^{n-2}, each from its
    // operand at rows i and i + 1, and the RHS B w1 + C w2
    // (pallas_step.py:376-415)
    const float a_t = p.c_a0 - 2.0f * sig1 * k / hh_t;
    const float b_t = theta + 2.0f * sig0 * k + 4.0f * sig1 * k / hh_t;
    const float z_keep = fminf(fmaxf(N_t + N_l + 2.0f - p.M_t_sem, 0.0f), n_l);
    float mms_c1 = 0.0f, mms_c2 = 0.0f, mms_cos = 0.0f, mms_exp = 0.0f, mms_fz = 0.0f;
    if constexpr (kMms) {
      // -forcing k^2, the forcing p_a (c1 cos^2(pi x) + c2 cos(2 pi x))
      // cos(gamma t) exp(-sig0 t), constants folded as the plain version
      // folds them
      const float t_now = (static_cast<float>(t + 2) - (p.mms_centered ? 1.0f : 0.0f)) * k;
      mms_c1 = sig0 * sig0 - gamma * gamma - 2.0f * sig0 * sig0;
      mms_c2 = p.two_mu2 * (4.0f * KK * p.mu2 + gamma * gamma);
      mms_cos = cosf(gamma * t_now);
      mms_exp = expf(-sig0 * t_now);
    }
    const float p_a = kMms ? p.p_a[b] : 0.0f;
    auto force = [&](float x) {
      const float cx = cosf(p.pi_f * x);
      return p_a * (mms_c1 * (cx * cx) + mms_c2 * cosf(p.two_pi * x)) * mms_cos * mms_exp;
    };
    if constexpr (kMms) mms_fz = force(0.5f);
    // the bow's raised cosine over the first M_t rows, its normalizer
    // sum |rc|, and the hammer's contact point (pallas_step.py:418-447)
    float v_b = 0.0f, F_b = 0.0f, tol_t = 0.0f, eps_idx = -1.0f;
    float eta_1 = 0.0f, eta_2 = 0.0f, f_pow = 0.0f;
    float wid_b = 0.0f, ctr = 0.0f, wd = 0.0f;
    if constexpr (kBow) {
      v_b = v_bt;
      F_b = F_bt;
      wid_b = wid_t * h_t;
      const float nmin1 = N_t - 1.0f;
      ctr = x_bt * nmin1 / p.M_t_sem_f;
      wd = wid_b * nmin1 / p.M_t_sem_f;
    }
    if constexpr (kHammer) {
      tol_t = static_cast<float>(pow(static_cast<double>(h_t), p.relative_error));
      eps_idx = floorf(x_H * (N_t - 1.0f));
    }
    auto eps_prof = [&](int i) { return static_cast<float>(i) == eps_idx ? 1.0f : 0.0f; };
    // the bow's sum |rc| in double (see exc_scalars), the hammer's two
    // masked sums
    double r_bow[1] = {0.0};
    float r_ham[2] = {0.0f, 0.0f};
#pragma unroll 2
    for (int i = tid; i < W; i += kThreads) {
      const float itf = static_cast<float>(i);
      const float lam = sLam[i];
      const float lam2 = lam * lam;
      const float lam_n = at(sLam, i + 1);
      const float d_next = lam_n * lam_n;
      const bool last = i + 1 >= W;
      const float q1 = lam * d_t(sT0[i] - at(sT0, i - 1));
      const float q2 = lam * d_t(sT1[i] - at(sT1, i - 1));
      const float q1_n = last ? 0.0f : lam_n * d_t(sT0[i + 1] - sT0[i]);
      const float q2_n = last ? 0.0f : lam_n * d_t(sT1[i + 1] - sT1[i]);
      const float iu2 = interp(sT2, tlLo, tlFr, i, n_t, n_l);
      const float iu2_n = last ? 0.0f : interp(sT2, tlLo, tlFr, i + 1, n_t, n_l);
      const float K_tl1 = -phi_pow * d_t(q1_n - q1);
      const float K_tl2 = -phi_pow * d_t(q2_n - q2);
      const float K_lt2 = -phi_pow * d_l(iu2_n - iu2);
      const float u1 = U1(i), u2 = U2(i), z1 = Z1(i), z2 = Z2(i);
      const float u1p = U1(i + 1), u1m = U1(i - 1);
      const float u2p = U2(i + 1), u2m = U2(i - 1);
      const float theta_u1 = theta * u1 + p.c_half * (u1p + u1m);
      const float theta_u2 = theta * u2 + p.c_half * (u2p + u2m);
      const float dxx_u1 = d_tt(u1p - 2.0f * u1 + u1m);
      const float dxx_u2 = d_tt(u2p - 2.0f * u2 + u2m);
      const float pent = U1(i + 2) - 4.0f * u1p + 6.0f * u1 - 4.0f * u1m + U1(i - 2);
      const float corr = (i == 1 || itf == n_t - 2.0f) ? u1 : 0.0f;
      const float dxxxx_u1 = d_t4(pent + corr);
      const float V_u2 = d_tt(-phi_pow * (lam2 * u2m - (lam2 + d_next) * u2 + d_next * u2p));
      const float B1u1 = -2.0f * theta_u1 - gamma_k * dxx_u1 + KK * p.k2 * dxxxx_u1;
      const float C1u2 = theta_u2 - 2.0f * sig0 * k * u2 + 2.0f * sig1 * k * dxx_u2 + V_u2;
      float rhs_u0 = B1u1 + C1u2 + 2.0f * K_tl1 + K_tl2;
      const float dxx_z1 = d_ll(Z1(i + 1) - 2.0f * z1 + Z1(i - 1));
      const float dxx_z2 = d_ll(Z2(i + 1) - 2.0f * z2 + Z2(i - 1));
      const float B4z1 = -2.0f * z1 - gamma_k * (alpha * alpha) * dxx_z1;
      const float C4z2 = (1.0f - 2.0f * sig0 * k) * z2 + 2.0f * sig1 * k * dxx_z2;
      float rhs_z = B4z1 + C4z2 + K_lt2;
      if constexpr (kMms) {
        const float x_u = (fminf(fmaxf(2.0f * itf / N_t, 0.0f), 2.0f) - 1.0f) / 2.0f;
        rhs_u0 = rhs_u0 - force(x_u) * p.k2;
        rhs_z = rhs_z - mms_fz * p.k2;
      }
      sRu0[i] = rhs_u0;
      sRz[i] = rhs_z * (itf < z_keep ? 1.0f : 0.0f);
      // the t system's row (pallas_step.py:360-374) scaled to unit
      // diagonal, into the arrays the sweeps fill only after the factor
      const float sub_t = (i >= 1 && itf < n_t) ? a_t - d_tt(phi_pow * lam2) : 0.0f;
      const float diag_t = itf < n_t ? b_t + d_tt(phi_pow * (lam2 + d_next)) : 1.0f;
      const float sup_t = itf < n_t - 1.0f ? a_t - d_tt(phi_pow * d_next) : 0.0f;
      const float rb_t = 1.0f / diag_t;
      sT3[i] = sub_t * rb_t;
      sUg[i] = sup_t * rb_t;
      sZg[i] = rb_t;
      sKtl[i] = K_tl1;
      sUc[i] = u1;
      sZc[i] = z1;
      if constexpr (kBow) {
        const float xax = (itf + 1.0f) / p.M_t_sem_f;
        const float ind = nan_sign(nan_max(-(xax - ctr - wd / 2.0f) * (xax - ctr + wd / 2.0f), 0.0f));
        float rc = 0.5f * ind * (1.0f + cosf(p.two_pi * (xax - ctr) / wd));
        rc = rc * (i < p.M_t_sem ? 1.0f : 0.0f);
        sRc[i] = rc;
        r_bow[0] += static_cast<double>(fabsf(rc));
      }
      if constexpr (kHammer) {
        // masked sums, as the JAX kernel takes them: a NaN anywhere in the
        // row reaches the result
        r_ham[0] += eps_prof(i) * u1;
        r_ham[1] += eps_prof(i) * u2;
      }
    }
    clk.mark(kPhRhs);
    if constexpr (kExc) {
      if constexpr (kBow) {
        group_reduce<1, false>(r_bow, sRed, red_par);
        const float norm = static_cast<float>(r_bow[0]);
        for (int i = tid; i < W; i += kThreads) sRc[i] = sRc[i] / norm;
      }
      if constexpr (kHammer) {
        group_reduce<2, false>(r_ham, sRed, red_par);
        eta_1 = uH1 - r_ham[0];
        eta_2 = uH2 - r_ham[1];
        // iteration-invariant factor of the power-law force; pow in double
        // and rounded once, as close to the plain version's powf as it gets
        f_pow = static_cast<float>(pow(static_cast<double>(w_H), static_cast<double>(1.0f + a_H))) *
                static_cast<float>(pow(static_cast<double>(nan_max(eta_1, 0.0f)),
                                       static_cast<double>(a_H - 1.0f)));
      }
      clk.mark(kPhExcitation);
    }

    // ---- LHS tridiagonals (pallas_step.py:360-374), factored once: the t
    // system's scaled rows from pass 3, the l system's Toeplitz rows (its
    // live rows' diagonal is b_l) --------------------------------------------
    auto coef_t = [&](int i, float& a, float& c, float& rb) {
      a = sT3[i];
      c = sUg[i];
      rb = sZg[i];
    };
    const float a_l = -2.0f * sig1 * k / hh_l;
    const float b_l = 1.0f + 2.0f * sig0 * k + 4.0f * sig1 * k / hh_l;
    const float rb_l = 1.0f / b_l;
    auto coef_l = [&](int i, float& a, float& c, float& rb) {
      const float itf = static_cast<float>(i);
      a = ((i >= 1 && itf < n_l) ? a_l : 0.0f) * rb_l;
      c = (itf < n_l - 1.0f ? a_l : 0.0f) * rb_l;
      rb = rb_l;
    };
    group_sync();  // pass 3's rows
    // warp 0 factors the t system while warp 1 factors the l system
    if (warp == 0) {
      factor(coef_t, blk_t, fT, lT, fs, lane);
    } else if (warp == 1) {
      factor(coef_l, blk_l, fL, lL, fs, lane);
    }
    clk.mark(kPhFactorT);
    group_sync();
    clk.mark(kPhFactorL);

    // excitation RHS linearized at the iterate u_it (pallas_step.py:452-503),
    // shared by the sweeps and the GMRES rescue: the per-string scalars
    // (the bow's F_b phi, the hammer's F_H) and the probe values.  `first`
    // selects the bow's first-iterate probe velocity (u1 - u2) / k.  Called
    // by the whole warpgroup.  The bow's sums, which the friction law turns
    // into the step's force, accumulate in double and round once, as the
    // plain version's do (string_kernel.py::_sum64), so that the two agree
    // whatever the order of the terms.
    float gb = 0.0f;
    auto exc_scalars = [&](const float* u_it, bool first, float& v_rel, float& F_H,
                           float& u_H) {
      if constexpr (kExc) {
        double sb[1] = {0.0};
        float sh[1] = {0.0f};
        for (int i = tid; i < W; i += kThreads) {
          if constexpr (kBow) {
            const float du = first ? U1(i) - U2(i) : u_it[i] - U1(i);
            sb[0] += static_cast<double>(sRc[i] * (du / k - v_b));
          }
          if constexpr (kHammer) sh[0] += eps_prof(i) * u_it[i];
        }
        if constexpr (kBow) {
          group_reduce<1, false>(sb, sRed, red_par);
          v_rel = static_cast<float>(sb[0]);
          gb = F_b * (nan_sign(v_rel) * (phi1 + (1.0f - phi1) * expf(-phi0 * fabsf(v_rel))));
        }
        if constexpr (kHammer) {
          // inner fixed point on the string's scalars, at least one pass
          group_reduce<1, false>(sh, sRed, red_par);
          const float eps_u = sh[0];
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
        }
        clk.mark(kPhExcitation);
      }
    };
    // this row's u RHS at the last exc_scalars: rhs_u0 plus the bow's and
    // the hammer's terms, masked to the live rows
    auto rhs_u = [&](int i, float F_H) -> float {
      float rhs = sRu0[i];
      if constexpr (kBow) rhs = rhs + bm * nan_to_num(-p.k2 * d_t(sRc[i]) * gb);
      if constexpr (kHammer) rhs = rhs + hm * nan_to_num(-p.k2 * eps_prof(i) * (M_r * F_H));
      return rhs * live_t(i);
    };
    // the t solve's RHS -rhs_u - K_tl(z_in) into sUg (with_rhs false: the
    // RHS-free sweep's -0 - K_tl), K_tl through the l->t interpolation
    auto t_rhs = [&](const float* z_in, bool with_rhs, float F_H) {
      group_sync();
#pragma unroll 2
      for (int i = tid; i < W; i += kThreads) sT0[i] = interp(z_in, ltLo, ltFr, i, n_l, n_t);
      group_sync();
#pragma unroll 2
      for (int i = tid; i < W; i += kThreads) {
        const float q = sLam[i] * d_t(sT0[i] - at(sT0, i - 1));
        const float q_n = i + 1 >= W ? 0.0f : sLam[i + 1] * d_t(sT0[i + 1] - sT0[i]);
        const float ktl = -phi_pow * d_t(q_n - q);
        sUg[i] = (with_rhs ? -rhs_u(i, F_H) : -0.0f) - ktl;
      }
      clk.mark(kPhStencilLT);
    };
    auto solve_t = [&]() {
      group_sync();
      if (warp == 0) solve(sUg, blk_t, fT, lT, fs, lane);
      group_sync();
      clk.mark(kPhSolveT);
    };
    // the z half of a sweep from the u in sUg: K_lt, then the l solve into
    // sZg (with_rhs false: the RHS-free sweep's)
    auto z_solve = [&](bool with_rhs) {
#pragma unroll 2
      for (int i = tid; i < W; i += kThreads)
        sT2[i] = sLam[i] * d_t(sUg[i] - at(sUg, i - 1));
      group_sync();
#pragma unroll 2
      for (int i = tid; i < W; i += kThreads) {
        const float iu = interp(sT2, tlLo, tlFr, i, n_t, n_l);
        const float iu_n = i + 1 >= W ? 0.0f : interp(sT2, tlLo, tlFr, i + 1, n_t, n_l);
        const float K_lt = -phi_pow * d_l(iu_n - iu);
        sZg[i] = (with_rhs ? -sRz[i] : -0.0f) - K_lt;
      }
      group_sync();
      clk.mark(kPhStencilTL);
      if (warp == 0) solve(sZg, blk_l, fL, lL, fs, lane);
      group_sync();
      clk.mark(kPhSolveL);
    };

    // ---- adaptive damped block Gauss-Seidel (pallas_step.py:505-578), or
    // the fixed schedule's plain sweeps (:517-519, :562-570) ----------------
    float omega = 1.0f, prev = INFINITY, scale_u = 0.0f;
    float v_rel = 0.0f, F_H = 0.0f, u_H = 0.0f;  // probe values of the last sweep
    bool hopeless = false;
    for (int sweep = 0;; ++sweep) {
      if constexpr (kExc) exc_scalars(sUc, sweep == 0, v_rel, F_H, u_H);
      if (sweep > 0) {
        t_rhs(sZc, true, F_H);
      } else {  // sweep 1 reuses the RHS pass's z interpolation
        for (int i = tid; i < W; i += kThreads) sUg[i] = -rhs_u(i, F_H) - sKtl[i];
        clk.mark(kPhStencilLT);
      }
      solve_t();
      z_solve(true);
      clk.sweep();
      if constexpr (kFixed) {  // plain sweeps: no relaxation, reduction or exit test
        for (int i = tid; i < W; i += kThreads) {
          sUc[i] = sUg[i];
          sZc[i] = sZg[i];
        }
        group_sync();
        if (sweep + 1 >= p.coupling_fixed) break;
        continue;
      }
      float red[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int i = tid; i < W; i += kThreads) {
        const float u_c = sUc[i], z_c = sZc[i], u_g = sUg[i], z_g = sZg[i];
        const float u_c2 = u_c + omega * (u_g - u_c);
        red[0] = nan_max(red[0], fabsf(u_g - u_c));
        red[1] = nan_max(red[1], fabsf(z_g - z_c));
        red[2] = nan_max(red[2], fabsf(u_c2));
        sUc[i] = u_c2;
        sZc[i] = z_c + omega * (z_g - z_c);
      }
      group_reduce<3, true>(red, sRed, red_par);
      const float delta = red[0] + red[1];
      const bool grew = delta > prev;
      const bool hop = grew && omega <= kOmegaFloor;
      if (grew) omega = fmaxf(omega * 0.5f, kOmegaFloor);
      prev = delta;
      hopeless = hop;
      scale_u = red[2] + inner_eps;
      const bool live_err = delta > inner_eps * scale_u && !hop;
      clk.mark(kPhExit);
      if (!live_err || sweep + 1 >= p.coupling_iters) break;
    }
    group_sync();

    // ---- untrusted exits (pallas_step.py:593-609): hopeless, non-finite or
    // above tolerance at the sweep cap; uniform across the CTA.  Poisoned,
    // or in the kGmres instance solved again by GMRES (:610-764).  The fixed
    // schedule has no exit test and trusts every exit ----------------------
    const bool bad =
        !kFixed && (hopeless || !(prev < INFINITY) || prev > inner_eps * scale_u);
    bool poison = bad && !kGmres;
    if constexpr (kGmres) {
      if (bad) {
        // GMRES(m) on (I - G) z = c from z = 0, G z the z of one RHS-free
        // sweep from z: one pass, or two with an excitation, the second's
        // RHS linearized at the first pass's u.  sUc holds u_lin, sZc z_sol
        float relres = 0.0f;
        for (int i = tid; i < W; i += kThreads) sUc[i] = U1(i);
        for (int pass = 0; pass < (kExc ? 2 : 1); ++pass) {
          exc_scalars(sUc, pass == 0, v_rel, F_H, u_H);
          for (int i = tid; i < W; i += kThreads) sZc[i] = 0.0f;
          t_rhs(sZc, true, F_H);
          solve_t();
          z_solve(true);  // c in sZg
          // the inner products accumulate in double, as the bow's sums do
          double r1[1] = {0.0};
          for (int i = tid; i < W; i += kThreads) r1[0] += static_cast<double>(sZg[i] * sZg[i]);
          group_reduce<1, false>(r1, sRed, red_par);
          const float beta = sqrtf(static_cast<float>(r1[0]));
          for (int i = tid; i < W; i += kThreads) sV[i] = sZg[i] * sdiv(1.0f, beta);
          float g_cur = beta, res = beta;
          int n_it = 0;
#pragma unroll 1
          for (int ii = 0; ii < kGmresM && res > 1e-6f * beta; ++ii) {
            const float* vi = sV + ii * W;
            float* w = sV + (ii + 1) * W;
            clk.mark(kPhGmres);
            t_rhs(vi, false, F_H);
            solve_t();
            z_solve(false);
            for (int i = tid; i < W; i += kThreads) w[i] = vi[i] - sZg[i];
            // modified Gram-Schmidt, one group reduction per basis row
#pragma unroll 1
            for (int j = 0; j <= ii; ++j) {
              const float* vj = sV + j * W;
              double h64[1] = {0.0};
              for (int i = tid; i < W; i += kThreads) h64[0] += static_cast<double>(w[i] * vj[i]);
              group_reduce<1, false>(h64, sRed, red_par);
              const float h = static_cast<float>(h64[0]);
              for (int i = tid; i < W; i += kThreads) w[i] = w[i] - h * vj[i];
              if (tid == 0) sH[j] = h;
            }
            double hn[1] = {0.0};
            for (int i = tid; i < W; i += kThreads) hn[0] += static_cast<double>(w[i] * w[i]);
            group_reduce<1, false>(hn, sRed, red_par);
            const float hlast = sqrtf(static_cast<float>(hn[0]));
            for (int i = tid; i < W; i += kThreads) w[i] = w[i] * sdiv(1.0f, hlast);
            group_sync();  // publishes sH
            // the earlier Givens rotations on the new column, then its own
            float a = sH[0];
#pragma unroll 1
            for (int j = 0; j < ii; ++j) {
              const float bj = sH[j + 1], cj = sCs[j], sj = sSn[j];
              const float rj = cj * a + sj * bj;
              a = -sj * a + cj * bj;
              if (tid == 0) sR[ii * kGmresM + j] = rj;
            }
            const float den = sqrtf(a * a + hlast * hlast);
            const float ci = sdiv(a, den), si = sdiv(hlast, den);
            group_sync();  // every thread has read sCs, sSn
            if (tid == 0) {
              sCs[ii] = ci;
              sSn[ii] = si;
              sR[ii * kGmresM + ii] = den;
              sG[ii] = ci * g_cur;
            }
            g_cur = -si * g_cur;
            res = fabsf(g_cur);
            ++n_it;
            group_sync();
            clk.mark(kPhGmres);
          }
          if (tid == 0) {  // back substitution on R y = g
            for (int i2 = n_it - 1; i2 >= 0; --i2) {
              float acc = sG[i2];
              for (int j = i2 + 1; j < n_it; ++j) acc = acc - sR[j * kGmresM + i2] * sY[j];
              sY[i2] = sdiv(acc, sR[i2 * kGmresM + i2]);
            }
          }
          group_sync();
          for (int i = tid; i < W; i += kThreads) {
            float z_sol = 0.0f;
            for (int i2 = 0; i2 < n_it; ++i2) z_sol = z_sol + sY[i2] * sV[i2 * W + i];
            sZc[i] = z_sol;
          }
          relres = sdiv(res, beta);
          clk.mark(kPhGmres);
          t_rhs(sZc, true, F_H);
          solve_t();
          for (int i = tid; i < W; i += kThreads) sUc[i] = sUg[i];
          group_sync();
        }
        // accepted when the Krylov residual is small, else poisoned
        poison = !(relres <= 1e-3f);
        clk.mark(kPhGmres);
      }
    }

    // ---- Dirichlet rows (pallas_step.py:765-766; multiplying keeps a NaN
    // row NaN), the readout (:768-787), the state and the carry -----------
    float sums[kSurface ? 2 : 4] = {};
    const float u_ri = 1.0f + floorf(N_t * pos);
    const float z_ri = 1.0f + floorf(N_l * pos);
    for (int i = tid; i < W; i += kThreads) {
      const float itf = static_cast<float>(i);
      const float u_n = (poison ? NAN : sUc[i]) * live_t(i) * (i != 0 ? 1.0f : 0.0f) *
                        (itf != N_t ? 1.0f : 0.0f);
      const float z_n = sZc[i] * (itf < n_l ? 1.0f : 0.0f) * (i != 0 ? 1.0f : 0.0f) *
                        (itf != N_l ? 1.0f : 0.0f);
      if constexpr (kSurface) {
        sums[0] += u_n - su1[i];
        sums[1] += z_n - sz1[i];
      } else {  // interpolated pickup, taps as masked sums
        sums[0] += (itf == u_ri ? 1.0f : 0.0f) * u_n;
        sums[1] += (itf == u_ri + 1.0f ? 1.0f : 0.0f) * u_n;
        sums[2] += (itf == z_ri ? 1.0f : 0.0f) * z_n;
        sums[3] += (itf == z_ri + 1.0f ? 1.0f : 0.0f) * z_n;
      }
      if (p.state_u != nullptr) {
        if (i < p.M_t) p.state_u[((size_t)t * p.B_rows + b) * p.ld_t + i] = u_n;
        if (i < p.M_l) p.state_z[((size_t)t * p.B_rows + b) * p.ld_l + i] = z_n;
      }
      su2[i] = su1[i];
      su1[i] = u_n;
      sz2[i] = sz1[i];
      sz1[i] = z_n;
    }
    group_reduce<kSurface ? 2 : 4, false>(sums, sRed, red_par);
    if (tid == 0) {
      if constexpr (kSurface) {
        float w_out = 0.5f * h_t;
        if constexpr (kExc) w_out = w_out * (1.0f + hm + bm);
        p.uout[(size_t)b * T + t] = sums[0] * w_out / k;
        p.zout[(size_t)b * T + t] = sums[1] * w_out / k;
      } else {
        const float u_rf = 1.0f + pos / h_t - u_ri, z_rf = 1.0f + pos / h_l - z_ri;
        p.uout[(size_t)b * T + t] = (1.0f - u_rf) * sums[0] + u_rf * sums[1];
        p.zout[(size_t)b * T + t] = (1.0f - z_rf) * sums[2] + z_rf * sums[3];
      }
    }
    if constexpr (kExc) {
      // probe traces and the uHs carry (pallas_step.py:791-802)
      if constexpr (!kHammer) {  // free ballistic hammer displacement
        u_H = nan_max(2.0f * uH1 - uH2 - kHammerClamp, 0.0f) + kHammerClamp;
      }
      if (tid == 0) {
        p.v_r[(size_t)b * T + t] = v_rel;
        p.F_H[(size_t)b * T + t] = F_H;
        p.u_H[(size_t)b * T + t] = u_H;
      }
      uH2 = uH1;
      uH1 = u_H;
    }
    group_sync();
    clk.mark(kPhReadout);
  }

  for (int i = tid; i < W; i += kThreads) {
    if (i < p.M_t) {
      p.u1_out[(size_t)b * p.ld_t + i] = su1[i];
      p.u2_out[(size_t)b * p.ld_t + i] = su2[i];
    }
    if (i < p.M_l) {
      p.z1_out[(size_t)b * p.ld_l + i] = sz1[i];
      p.z2_out[(size_t)b * p.ld_l + i] = sz2[i];
    }
  }
#ifdef STRING_STEP_CLOCKS
  group_sync();  // thread 0's last mark
  if (tid < kClockSlots) p.clocks[(size_t)b * kClockSlots + tid] = clk.acc[tid];
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
  kernel<<<p.B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instances, each as (index, bow, hammer, surface, gmres, mms, fixed):
// indices 0-15 are the gmres / bow / hammer / surface bits, 16-19 the MMS
// instances (gmres, surface), 20-21 the fixed schedule's (surface).
#define STRING_STEP_INSTANCES(X)                              \
  X(0, false, false, false, false, false, false)             \
  X(1, false, false, true, false, false, false)              \
  X(2, false, true, false, false, false, false)              \
  X(3, false, true, true, false, false, false)               \
  X(4, true, false, false, false, false, false)              \
  X(5, true, false, true, false, false, false)               \
  X(6, true, true, false, false, false, false)               \
  X(7, true, true, true, false, false, false)                \
  X(8, false, false, false, true, false, false)              \
  X(9, false, false, true, true, false, false)               \
  X(10, false, true, false, true, false, false)              \
  X(11, false, true, true, true, false, false)               \
  X(12, true, false, false, true, false, false)              \
  X(13, true, false, true, true, false, false)               \
  X(14, true, true, false, true, false, false)               \
  X(15, true, true, true, true, false, false)                \
  X(16, false, false, false, false, true, false)             \
  X(17, false, false, true, false, true, false)              \
  X(18, false, false, false, true, true, false)              \
  X(19, false, false, true, true, true, false)               \
  X(20, false, false, false, false, false, true)             \
  X(21, false, false, true, false, false, true)
#define STRING_STEP_NUM_INSTANCES 22

template <int I>
struct Instance;
#define STRING_STEP_TRAIT(i, b, h, s, g, m, f)                                   \
  template <>                                                                    \
  struct Instance<i> {                                                           \
    static constexpr bool bow = b, hammer = h, surface = s, gmres = g, mms = m, \
                          fixed = f;                                             \
  };
STRING_STEP_INSTANCES(STRING_STEP_TRAIT)

template <int I>
cudaError_t launch_instance(const Params& p, int W, cudaStream_t s) {
  using In = Instance<I>;
  return launch<In::bow, In::hammer, In::surface, In::gmres, In::mms, In::fixed>(p, W, s);
}

// The instance a launch runs.
int instance_index(const LaunchArgs* a) {
  const int surface = a->surface_integral != 0 ? 1 : 0;
  if (a->coupling_fixed > 0) return 20 + surface;
  if (a->manufactured != 0) return 16 + (a->gmres != 0 ? 2 : 0) + surface;
  return (a->gmres != 0 ? 8 : 0) | (a->has_bow != 0 ? 4 : 0) |
         (a->has_hammer != 0 ? 2 : 0) | surface;
}

}  // namespace

// A parallel build (ops/build.py) compiles this file once per instance with
// -DBUILD_PART=<index>, each translation unit holding that instance's kernel
// and its entry string_step_part_<index>, and once with
// -DBUILD_PART=STRING_STEP_NUM_INSTANCES for the dispatch and the entry
// points, which hold no kernel; without BUILD_PART one translation unit holds
// everything.
#define STRING_STEP_PASTE(a, b) a##b
#define STRING_STEP_PART_FN(i) STRING_STEP_PASTE(string_step_part_, i)

#if defined(BUILD_PART) && BUILD_PART < STRING_STEP_NUM_INSTANCES
extern "C" int STRING_STEP_PART_FN(BUILD_PART)(const void* p, int W, void* stream) {
  return static_cast<int>(launch_instance<BUILD_PART>(
      *static_cast<const Params*>(p), W, static_cast<cudaStream_t>(stream)));
}
#else
#if defined(BUILD_PART)
#define STRING_STEP_DECLARE(i, b, h, s, g, m, f) \
  extern "C" int string_step_part_##i(const void* p, int W, void* stream);
STRING_STEP_INSTANCES(STRING_STEP_DECLARE)
#define STRING_STEP_CASE(i, b, h, s, g, m, f) \
  case i: return static_cast<cudaError_t>(string_step_part_##i(&p, W, stream));
#else
#define STRING_STEP_CASE(i, b, h, s, g, m, f) \
  case i: return launch_instance<i>(p, W, stream);
#endif

namespace {

cudaError_t run_instance(int index, const Params& p, int W, cudaStream_t stream) {
  switch (index) {
    STRING_STEP_INSTANCES(STRING_STEP_CASE)
    default: return cudaErrorInvalidValue;
  }
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

  return static_cast<int>(
      run_instance(instance_index(a), p, W, static_cast<cudaStream_t>(stream)));
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
#endif  // BUILD_PART
