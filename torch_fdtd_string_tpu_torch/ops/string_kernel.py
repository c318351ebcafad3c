"""Fused string step: all T audio-rate steps of B independent strings.

PyTorch counterpart of ``torch_fdtd_string_tpu/ops/pallas_step.py``.  Each
step solves the implicit theta-scheme for the coupled transverse (u) and
longitudinal (z) displacement with adaptive damped block Gauss-Seidel
sweeps, each sweep two masked PCR tridiagonal solves, and reads the
surface-integral output.

:func:`string_chunked` dispatches on the device of its inputs:

* CUDA tensors launch the hand-written Hopper kernel ``csrc/string_step.cu``
  (built on first use by ``ops/build.py``) or raise;
* CPU tensors run :func:`string_chunked_reference`, the plain PyTorch
  version of the same algorithm, in float32 or float64.

Only the pluck specialization exists so far: no bow, no hammer, no MMS
forcing, poison-only exits (``gmres_rescue=False``), the adaptive sweep
schedule (``coupling_fixed=0``) and the surface-integral readout.  Every
other specialization raises ``NotImplementedError`` on both devices and
names the ROADMAP Queue 2 item that ports it.

Semantics follow the JAX kernel line by line with one deliberate change:
each string leaves its Gauss-Seidel loop on its own (convergence, hopeless
back-off or NaN), where the TPU kernel iterates the whole batch block until
every string is done.  A string's result therefore never depends on the
other strings in its batch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import stencils as st
from .fdm import LN10_6
from .tridiag import pcr_normalized

OMEGA_FLOOR = 0.0625  # under-relaxation floor of the adaptive sweeps

# csrc/string_step.cu::string_step_launch: 16 pointers (inputs, outputs,
# optional state fields), 7 ints, k/theta_t/lambda_c, the CUDA stream
_LAUNCH_ARGTYPES = (
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_double] * 3
    + [ctypes.c_void_p]
)


class KernelConsts(NamedTuple):
    k: float
    theta_t: float
    lambda_c: float
    M_t: int
    M_l: int
    coupling_iters: int
    collect_state: bool
    # allocation width that sets the z live-row count (pallas_step.py:101-106)
    M_t_sem: int


def padded_width(M_t, M_l):
    """Lane width of one string: max(M_t, M_l) rounded up to whole warps.
    Lanes past a string's live grid hold identity rows and zeros."""
    return 32 * -(-max(M_t, M_l) // 32)


def pcr_levels(width):
    """PCR levels that reach across ``width`` rows: ceil(log2(width))."""
    return max(1, (width - 1).bit_length())


def _consts(*, k, theta_t, lambda_c, M_t, M_l, coupling_iters, surface_integral,
            collect_state, bow, hammer, manufactured, coupling_fixed,
            gmres_rescue, M_t_sem):
    """Validate the requested specialization; raise for the unported ones."""
    missing = []
    if bow is not None:
        missing.append("bow excitation (ROADMAP Queue 2 item 5)")
    if hammer is not None:
        missing.append("hammer excitation (ROADMAP Queue 2 item 6)")
    if manufactured:
        missing.append("MMS forcing (ROADMAP Queue 2 item 7)")
    if gmres_rescue:
        missing.append("in-kernel GMRES rescue, gmres_rescue=True "
                       "(ROADMAP Queue 2 item 4)")
    if coupling_fixed > 0:
        missing.append("fixed sweep schedule, coupling_fixed>0 "
                       "(ROADMAP Queue 2 item 3)")
    if not surface_integral:
        missing.append("interpolated pickup readout, surface_integral=False "
                       "(ROADMAP Queue 2 item 2)")
    if missing:
        raise NotImplementedError(
            "string kernel specialization not ported: " + "; ".join(missing))
    if coupling_iters < 1:
        raise ValueError(f"coupling_iters must be >= 1, got {coupling_iters}")
    return KernelConsts(
        k=float(k), theta_t=float(theta_t), lambda_c=float(lambda_c),
        M_t=int(M_t), M_l=int(M_l), coupling_iters=int(coupling_iters),
        collect_state=bool(collect_state),
        M_t_sem=int(M_t if M_t_sem is None else M_t_sem),
    )


def string_chunked(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *,
                   k, theta_t, lambda_c, M_t, M_l, chunk=512,
                   coupling_iters=24, surface_integral=False, interpret=False,
                   batch_block=64, collect_state=False,
                   bow=None, hammer=None, relative_error=4.0,
                   manufactured=False, mms_centered=False, p_a=None,
                   coupling_fixed=0, gmres_rescue=True, gmres_m=16,
                   M_t_sem=None):
    """Run the fused string step over a full ``(B, T)`` f0 control signal.

    Arguments and results match the JAX ``string_chunked``:
    ``f0 (B, T)``, ``kappa/alpha/pos (B,)``, ``t60 (B, 2, 2)``,
    ``u1/u2 (B, M_t)``, ``z1/z2 (B, M_l)``.  Returns ``(uout (B, T),
    zout (B, T), aux)``; ``aux["carry"]`` is the final ``(u1, u2, z1, z2)``
    and, with ``collect_state``, ``aux["state_u"] (T, B, M_t)`` and
    ``aux["state_z"] (T, B, M_l)`` hold every step's state.

    ``chunk``, ``batch_block`` and ``interpret`` are the TPU kernel's
    tiling and have no effect here: the CUDA kernel loops over all T steps
    inside one block per string.  ``relative_error`` and ``mms_centered``
    matter only to the unported hammer and MMS specializations.
    """
    c = _consts(
        k=k, theta_t=theta_t, lambda_c=lambda_c, M_t=M_t, M_l=M_l,
        coupling_iters=coupling_iters, surface_integral=surface_integral,
        collect_state=collect_state, bow=bow, hammer=hammer,
        manufactured=manufactured, coupling_fixed=coupling_fixed,
        gmres_rescue=gmres_rescue, M_t_sem=M_t_sem,
    )
    args = (f0, kappa, alpha, t60, u1, u2, z1, z2)
    if f0.is_cuda:
        return _launch_cuda(c, *args)
    if f0.device.type == "cpu":
        return _reference(c, *args)
    raise ValueError(f"string_chunked: unsupported device {f0.device}")


string_chunked.launches = 0  # kernel launches; the CPU path does not count


def string_chunked_reference(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *,
                             k, theta_t, lambda_c, M_t, M_l, chunk=512,
                             coupling_iters=24, surface_integral=False,
                             interpret=False, batch_block=64,
                             collect_state=False, bow=None, hammer=None,
                             relative_error=4.0, manufactured=False,
                             mms_centered=False, p_a=None, coupling_fixed=0,
                             gmres_rescue=True, gmres_m=16, M_t_sem=None):
    """Plain PyTorch version of :func:`string_chunked` on any device.

    Same arguments, results and specialization limits.  Batched tensor ops
    in the inputs' dtype (float32 or float64), one Python iteration per
    step and per sweep.
    """
    c = _consts(
        k=k, theta_t=theta_t, lambda_c=lambda_c, M_t=M_t, M_l=M_l,
        coupling_iters=coupling_iters, surface_integral=surface_integral,
        collect_state=collect_state, bow=bow, hammer=hammer,
        manufactured=manufactured, coupling_fixed=coupling_fixed,
        gmres_rescue=gmres_rescue, M_t_sem=M_t_sem,
    )
    return _reference(c, f0, kappa, alpha, t60, u1, u2, z1, z2)


@torch.inference_mode()
def _reference(c: KernelConsts, f0, kappa, alpha, t60, u1, u2, z1, z2):
    B, T = f0.shape
    dt, dev = f0.dtype, f0.device
    W = padded_width(c.M_t, c.M_l)
    levels = pcr_levels(W)
    k, theta, lambda_c = c.k, c.theta_t, c.lambda_c
    inner_eps = 100.0 * float(torch.finfo(dt).eps)
    two_t = 2.0 * theta - 1.0

    def pad(x, M):
        return torch.nn.functional.pad(x, (0, W - M))

    u1s, u2s = pad(u1, c.M_t), pad(u2, c.M_t)
    z1s, z2s = pad(z1, c.M_l), pad(z2, c.M_l)
    kappa = kappa[:, None]
    alpha = alpha[:, None]
    t60f = t60.reshape(B, 4)
    freq1, time1, freq2, time2 = (t60f[:, j : j + 1] for j in range(4))
    it = torch.arange(W, device=dev)[None, :]
    itf = it.to(dt)
    one = torch.ones((B, 1), dtype=dt, device=dev)
    zero = torch.zeros((B, 1), dtype=dt, device=dev)

    uout = torch.empty((B, T), dtype=dt, device=dev)
    zout = torch.empty((B, T), dtype=dt, device=dev)
    if c.collect_state:
        state_u = torch.empty((T, B, c.M_t), dtype=dt, device=dev)
        state_z = torch.empty((T, B, c.M_l), dtype=dt, device=dev)

    def interp_idx(n_in, n_out):
        denom = torch.clamp(n_out - 1.0, min=1.0)
        posn = torch.minimum(torch.clamp(itf * (n_in - 1.0) / denom, min=0.0),
                             n_in - 1.0)
        lo = torch.floor(posn)
        frac = posn - lo
        lo_i = torch.clamp(lo.long(), 0, W - 1)
        hi_i = torch.minimum(lo_i + 1, torch.clamp(n_in.long() - 1, min=0))
        return lo_i, hi_i, frac, (itf < n_out).to(dt)

    def interp(src, d):
        lo_i, hi_i, frac, mask = d
        return (torch.gather(src, 1, lo_i) * (1.0 - frac)
                + torch.gather(src, 1, hi_i) * frac) * mask

    for t in range(T):
        # ---- per-step grid and loss terms (pallas_step.py:248-291) --------
        gamma = 2.0 * f0[:, t : t + 1]
        K = kappa * gamma
        g2 = gamma * gamma
        g4 = g2 * g2
        KK = K * K
        h_1 = lambda_c * torch.sqrt(
            (g2 * k**2 + torch.sqrt(g4 * k**4 + 16.0 * KK * k**2 * two_t))
            / (2.0 * two_t))
        N_t = torch.floor(1.0 / h_1)
        h_t = 1.0 / N_t
        h_2 = lambda_c * gamma * alpha * k
        N_l = torch.floor(1.0 / h_2)
        h_l = 1.0 / N_l
        n_t = N_t + 1.0
        n_l = N_l + 1.0

        gg = torch.where(gamma != 0.0, gamma, one)
        g2s = gg * gg

        def zeta(freq):
            x = 2 * math.pi * freq
            return torch.where(K > 0, -g2 + torch.sqrt(g4 + 4 * KK * (x * x)),
                               freq * freq / g2s)

        zeta1, zeta2 = zeta(freq1), zeta(freq2)
        lossy = (freq1 * time1 * freq2 * time2) != 0.0
        st1 = torch.where(time1 != 0.0, time1, one)
        st2 = torch.where(time2 != 0.0, time2, one)
        lossy_f = lossy.to(dt)
        sig0 = torch.where(lossy, -zeta2 / st1 + zeta1 / st2, lossy_f)
        sig1 = torch.where(lossy, 1.0 / st1 - 1.0 / st2, lossy_f)
        scale = LN10_6 / (zeta1 - zeta2)
        sig0 = scale * sig0
        sig1 = scale * sig1

        live_t = (itf < n_t).to(dt)
        live_l = (itf < n_l).to(dt)
        u1 = st.mask_live(u1s, n_t[:, 0])
        u2 = st.mask_live(u2s, n_t[:, 0])
        z1 = st.mask_live(z1s, n_l[:, 0])
        z2 = st.mask_live(z2s, n_l[:, 0])

        gamma_k = g2 * k**2
        phi_pow = gamma_k * (alpha * alpha - 1.0) / 4.0
        lam = st.dxb(u1, h_t)
        lam2 = lam * lam
        lt = interp_idx(n_l, n_t)  # z (l-grid) -> t-grid
        tl = interp_idx(n_t, n_l)  # u-derived (t-grid) -> l-grid
        hh_t = h_t * h_t
        hh_l = h_l * h_l

        def dxxxx_cl(x):
            pent = (st.shift(x, -2) - 4.0 * st.shift(x, -1) + 6.0 * x
                    - 4.0 * st.shift(x, 1) + st.shift(x, 2))
            corr = torch.where((it == 1) | (itf == (n_t - 2.0)), x,
                               torch.zeros_like(x))
            return (pent + corr) / (hh_t * hh_t)

        def K_tl_from(w):
            return -phi_pow * st.dxf(lam * st.dxb(w, h_t), h_t)

        def K_lt_from(w):
            return -phi_pow * st.dxf(w, h_l)

        # ---- LHS tridiagonals (pallas_step.py:360-374) ---------------------
        a_t = (1.0 - theta) / 2.0 - 2.0 * sig1 * k / hh_t
        b_t = theta + 2.0 * sig0 * k + 4.0 * sig1 * k / hh_t
        d_next = st.shift(lam2, -1)
        zeros = torch.zeros_like(lam2)
        sub_t = torch.where((it >= 1) & (itf < n_t),
                            a_t - phi_pow * lam2 / hh_t, zeros)
        diag_t = torch.where(itf < n_t,
                             b_t + phi_pow * (lam2 + d_next) / hh_t,
                             torch.ones_like(lam2))
        sup_t = torch.where(itf < (n_t - 1.0),
                            a_t - phi_pow * d_next / hh_t, zeros)
        a_l = -2.0 * sig1 * k / hh_l
        b_l = 1.0 + 2.0 * sig0 * k + 4.0 * sig1 * k / hh_l
        sub_l = torch.where((it >= 1) & (itf < n_l), a_l, zeros)
        diag_l = torch.where(itf < n_l, b_l, torch.ones_like(lam2))
        sup_l = torch.where(itf < (n_l - 1.0), a_l, zeros)

        # ---- RHS B w1 + C w2 (pallas_step.py:376-415) ----------------------
        iz1 = interp(z1, lt)
        iz2 = interp(z2, lt)
        iu2 = interp(lam * st.dxb(u2, h_t), tl)
        V_u2 = -phi_pow * (
            lam2 * st.shift(u2, 1) - (lam2 + d_next) * u2
            + d_next * st.shift(u2, -1)) / hh_t
        B1u1 = (-2.0 * st.theta_op(u1, theta) - gamma_k * st.dxx(u1, h_t)
                + KK * k**2 * dxxxx_cl(u1))
        C1u2 = (st.theta_op(u2, theta) - 2.0 * sig0 * k * u2
                + 2.0 * sig1 * k * st.dxx(u2, h_t) + V_u2)
        K_tl1 = K_tl_from(iz1)
        rhs_u = (B1u1 + C1u2 + 2.0 * K_tl1 + K_tl_from(iz2)) * live_t
        B4z1 = -2.0 * z1 - gamma_k * (alpha * alpha) * st.dxx(z1, h_l)
        C4z2 = (1.0 - 2.0 * sig0 * k) * z2 + 2.0 * sig1 * k * st.dxx(z2, h_l)
        rhs_z = B4z1 + C4z2 + K_lt_from(iu2)
        z_keep = torch.minimum(
            torch.clamp(N_t + N_l + 2.0 - c.M_t_sem, min=0.0), n_l)
        rhs_z = rhs_z * (itf < z_keep).to(dt)

        # ---- adaptive damped block Gauss-Seidel (pallas_step.py:505-578),
        # each string frozen once it has exited
        u_c, z_c = u1, z1
        omega = torch.ones((B, 1), dtype=dt, device=dev)
        prev = torch.full((B, 1), math.inf, dtype=dt, device=dev)
        hopeless = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        scale_u = zero
        active = torch.ones((B, 1), dtype=torch.bool, device=dev)
        K_tl = K_tl1  # sweep 1 reuses the RHS pass's z interpolation
        for sweep in range(c.coupling_iters):
            if sweep > 0:
                K_tl = K_tl_from(interp(z_c, lt))
            u_g = pcr_normalized(sub_t, diag_t, sup_t, -rhs_u - K_tl, levels)
            iu = interp(lam * st.dxb(u_g, h_t), tl)
            z_g = pcr_normalized(sub_l, diag_l, sup_l, -rhs_z - K_lt_from(iu),
                                 levels)
            u_c2 = u_c + omega * (u_g - u_c)
            z_c2 = z_c + omega * (z_g - z_c)
            delta = (torch.amax(torch.abs(u_g - u_c), dim=1, keepdim=True)
                     + torch.amax(torch.abs(z_g - z_c), dim=1, keepdim=True))
            grew = delta > prev
            hop = grew & (omega <= OMEGA_FLOOR)
            omega_n = torch.where(grew, torch.clamp(omega * 0.5, min=OMEGA_FLOOR),
                                  omega)
            scale_b = torch.amax(torch.abs(u_c2), dim=1, keepdim=True) + inner_eps
            u_c = torch.where(active, u_c2, u_c)
            z_c = torch.where(active, z_c2, z_c)
            omega = torch.where(active, omega_n, omega)
            prev = torch.where(active, delta, prev)
            hopeless = torch.where(active, hop, hopeless)
            scale_u = torch.where(active, scale_b, scale_u)
            active = active & (delta > inner_eps * scale_b) & ~hop
            if not bool(active.any()):
                break

        # ---- poison untrusted exits, Dirichlet rows (pallas_step.py:593-609,
        # 765-766) -----------------------------------------------------------
        bad = hopeless | ~(prev < math.inf) | (prev > inner_eps * scale_u)
        u_n = torch.where(bad, torch.full_like(u_c, math.nan), u_c)
        u_n = u_n * live_t * (it != 0).to(dt) * (itf != N_t).to(dt)
        z_n = z_c * live_l * (it != 0).to(dt) * (itf != N_l).to(dt)

        # ---- surface-integral readout (pallas_step.py:771-774) -------------
        w_out = 0.5 * h_t
        uout[:, t : t + 1] = torch.sum(u_n - u1s, dim=1, keepdim=True) * w_out / k
        zout[:, t : t + 1] = torch.sum(z_n - z1s, dim=1, keepdim=True) * w_out / k
        if c.collect_state:
            state_u[t] = u_n[:, : c.M_t]
            state_z[t] = z_n[:, : c.M_l]
        u2s, u1s = u1s, u_n
        z2s, z1s = z1s, z_n

    aux = {"carry": (u1s[:, : c.M_t], u2s[:, : c.M_t],
                     z1s[:, : c.M_l], z2s[:, : c.M_l])}
    if c.collect_state:
        aux["state_u"] = state_u
        aux["state_z"] = state_z
    return uout, zout, aux


def _launch_cuda(c: KernelConsts, f0, kappa, alpha, t60, u1, u2, z1, z2):
    """Check the inputs, allocate the outputs and launch ``string_step``."""
    from . import build

    B, T = f0.shape
    W = padded_width(c.M_t, c.M_l)
    shapes = {
        "f0": (f0, (B, T)), "kappa": (kappa, (B,)), "alpha": (alpha, (B,)),
        "t60": (t60, (B, 2, 2)), "u1": (u1, (B, c.M_t)), "u2": (u2, (B, c.M_t)),
        "z1": (z1, (B, c.M_l)), "z2": (z2, (B, c.M_l)),
    }
    for name, (x, shape) in shapes.items():
        if x.device != f0.device:
            raise ValueError(f"{name} is on {x.device}, f0 on {f0.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA string kernel takes float32; {name} is "
                            f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T < 1 or B < 1:
        raise ValueError(f"empty run: B={B}, T={T}")
    if W > 1024:
        raise ValueError(f"grid width {W} exceeds one thread block (1024)")

    launch = build.load_kernel_library("string_step").string_step_launch
    launch.argtypes = _LAUNCH_ARGTYPES
    launch.restype = ctypes.c_int
    opts = dict(dtype=torch.float32, device=f0.device)
    uout = torch.empty((B, T), **opts)
    zout = torch.empty((B, T), **opts)
    carry = tuple(torch.empty((B, M), **opts)
                  for M in (c.M_t, c.M_t, c.M_l, c.M_l))
    if c.collect_state:
        state_u = torch.empty((T, B, c.M_t), **opts)
        state_z = torch.empty((T, B, c.M_l), **opts)
        su_ptr, sz_ptr = state_u.data_ptr(), state_z.data_ptr()
    else:
        su_ptr = sz_ptr = None
    t60f = t60.reshape(B, 4)  # (freq1, time1, freq2, time2), contiguous view
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        rc = launch(
            f0.data_ptr(), kappa.data_ptr(), alpha.data_ptr(), t60f.data_ptr(),
            u1.data_ptr(), u2.data_ptr(), z1.data_ptr(), z2.data_ptr(),
            uout.data_ptr(), zout.data_ptr(),
            *(x.data_ptr() for x in carry), su_ptr, sz_ptr,
            B, T, c.M_t, c.M_l, W, c.M_t_sem, c.coupling_iters,
            c.k, c.theta_t, c.lambda_c, stream,
        )
    if rc != 0:
        raise RuntimeError(f"string_step launch failed: CUDA error {rc}")
    string_chunked.launches += 1
    aux = {"carry": carry}
    if c.collect_state:
        aux["state_u"] = state_u
        aux["state_z"] = state_z
    return uout, zout, aux
