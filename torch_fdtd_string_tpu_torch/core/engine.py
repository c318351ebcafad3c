"""The scan engine for the coupled transverse/longitudinal stiff string.

PyTorch port of ``torch_fdtd_string_tpu/core/engine.py`` (reference
``string.cpp``, ``bow.cpp``, ``hammer.cpp``, ``simulator.cpp``): one
implicit theta-scheme step per audio sample, the LHS blocks solved as masked
tridiagonal systems (``ops/tridiag.py``) and the thin cross-grid couplings
folded into a coupled solve, with the bow's and the hammer's nonlinear
excitation in an outer Picard loop.

Every function takes its device and dtype from its tensors; each loop is a
Python loop over batched tensor ops.  Where the JAX engine's loop is
batch-wide (the hammer fixed point, the damped Gauss-Seidel sweeps, the
Picard loop's exit), so is this one, and where it is per string (the Picard
freeze, the vmapped GMRES) the strings carry masks.  The
``coupling_solver="gmres"`` solve is the f64 rescue's: a GMRES per string,
each with its own Krylov space, so a NaN string cannot touch its
neighbours.

The dataset path runs the fused string kernel (``ops/string_kernel.py``)
for its first pass; this engine is the f64 rescue's solver
(``tasks/simulate.py::rescue_nan_elements``) and the truth the tests hold
the kernel to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import stencils as st
from ..ops.fdm import get_derived_vars, t60_to_sigma
from ..ops.tridiag import tridiag_matvec, tridiag_solve

# hammer displacement clamp (hammer.cpp:3); the reference initialises the
# hammer's displacement buffer with -1e-3 instead (simulator.py:507)
M_HD_CLAMP = -0.01


class SimConsts(NamedTuple):
    """Run constants (same fields and defaults as the JAX package)."""

    k: float
    theta_t: float
    lambda_c: float
    relative_error: float
    M_t: int  # static padded transverse width (Nx_t + 1)
    M_l: int  # static padded longitudinal width (Nx_l + 1)
    surface_integral: bool = False
    manufactured: bool = False
    picard_max_iter: int = 40
    hammer_max_iter: int = 40
    # coupled-solve sweeps per Picard iteration ("gs"), or with "gmres" 16
    # times the restart count (at least 2 restarts)
    coupling_max_iter: int = 8
    # convergence floor as a multiple of machine eps
    coupling_eps_factor: float = 100.0
    # "gs": damped block Gauss-Seidel; "gmres": block-GS-preconditioned
    # GMRES on the joint system (the f64 rescue)
    coupling_solver: str = "gs"
    # compile-time excitation switches: without an excitation the Picard
    # loop is skipped (its RHS cannot change) and v_r / F_H are 0
    has_bow: bool = True
    has_hammer: bool = True
    # > 0: that many plain Gauss-Seidel sweeps instead of the adaptive loop
    coupling_fixed_iters: int = 0
    collect_state: bool = True
    # MMS forcing at the scheme's middle time level (True) or at the
    # reference's n * k (False, bit-faithful)
    mms_centered: bool = False


class StringParams(NamedTuple):
    """Per-batch string parameters on the simulation device."""

    kappa: torch.Tensor  # (B,) relative stiffness
    alpha: torch.Tensor  # (B,) stiffness vs tension
    p_a: torch.Tensor  # (B,) max pluck amplitude (MMS forcing amplitude)
    f0: torch.Tensor  # (B, Nt) fundamental frequency control
    pos: torch.Tensor  # (B,) readout position
    T60: torch.Tensor  # (B, 2, 2) damping spec


class BowParams(NamedTuple):
    x_b: torch.Tensor  # (B, Nt)
    v_b: torch.Tensor  # (B, Nt)
    F_b: torch.Tensor  # (B, Nt)
    phi_0: torch.Tensor  # (B,)
    phi_1: torch.Tensor  # (B,)
    wid: torch.Tensor  # (B, Nt)


class HammerParams(NamedTuple):
    x_H: torch.Tensor  # (B,)
    w_H: torch.Tensor  # (B,)  (raw; divided by lambda_c in the step)
    M_r: torch.Tensor  # (B,)  (raw; divided by lambda_c in the step)
    alpha: torch.Tensor  # (B,)


class Carry(NamedTuple):
    u1: torch.Tensor  # (B, M_t) row n-1
    u2: torch.Tensor  # (B, M_t) row n-2
    z1: torch.Tensor  # (B, M_l)
    z2: torch.Tensor  # (B, M_l)
    uH1: torch.Tensor  # (B,)
    uH2: torch.Tensor  # (B,)


def _sign(x):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def hard_bow(v_rel, a, eps):
    """Friction curve (bow.cpp:10-12)."""
    return _sign(v_rel) * (eps + (1.0 - eps) * torch.exp(-a * torch.abs(v_rel)))


def soft_bow(v_rel, a, eps=None):
    """Smooth friction curve (bow.cpp:13-15)."""
    return torch.sqrt(2.0 * a) * v_rel * torch.exp(-a * v_rel**2 + 0.5)


def mms_forcing(gamma, sig0, K, p_a, x, t):
    """Manufactured-solution forcing term (vnv.cpp:11-37) with ``sigma ==
    sig0``, ``omega == gamma``, ``mu == pi``; the ``sin`` branch vanishes
    since sigma - sig0 == 0.  ``t`` is a scalar."""
    mu = math.pi
    g = gamma[:, None]
    s = sig0[:, None]
    coeff_1 = (s**2 - g**2 - 2.0 * s * s) * torch.cos(mu * x) ** 2
    coeff_2 = (2.0 * mu**2 * (4.0 * K[:, None] ** 2 * mu**2 + g**2)) * torch.cos(
        2.0 * mu * x)
    return p_a[:, None] * (coeff_1 + coeff_2) * torch.cos(g * t) * torch.exp(-s * t)


def _hammer_loop(uH1, uH2, eta_1, eta_2, alpha_H, w_H, eps_u, k, tol, mask,
                 max_iter):
    """Inner nonlinear hammer fixed point (hammer.cpp:11-54) on ``(B,)``
    quantities: at least one iteration, then on while any string moves by
    more than ``tol``.  Returns ``(F_H, u_H)``."""
    eta = eta_1 * mask
    f_pow = torch.pow(w_H, 1.0 + alpha_H) * torch.pow(torch.clamp(eta_1, min=0.0),
                                                       alpha_H - 1.0)
    for _ in range(max_iter):
        f_H = f_pow * (eta + eta_2) / 2.0
        F_H = torch.where(eta_1 > 0, f_H, torch.zeros_like(f_H))
        u_H = 2.0 * uH1 - uH2 - k**2 * F_H
        u_H = torch.clamp(u_H - M_HD_CLAMP, min=0.0) + M_HD_CLAMP
        eta_new = (u_H - eps_u) * mask
        res = torch.abs(eta - eta_new)
        eta = eta_new
        if not bool((res > tol).any()):
            break
    return F_H, u_H


def _norm(parts):
    """Per-string 2-norm over a tuple of ``(B, M)`` parts."""
    return torch.sqrt(sum(torch.sum(p * p, dim=-1) for p in parts))


def _safe_normalize(parts, thresh):
    """``x / |x|`` and ``|x|`` per string, both 0 where ``|x| <= thresh``
    (``jax.scipy.sparse.linalg._safe_normalize``)."""
    norm = _norm(parts)
    use = norm > thresh
    safe = torch.where(use, norm, torch.ones_like(norm))[:, None]
    unit = tuple(torch.where(use[:, None], p / safe, torch.zeros_like(p)) for p in parts)
    return unit, torch.where(use, norm, torch.zeros_like(norm))


def gmres(A, b, x0, M, *, tol, restart, maxiter):
    """Left-preconditioned GMRES per string, the semantics of
    ``jax.scipy.sparse.linalg.gmres(A, b, x0, M=M, tol=tol, atol=0,
    restart=restart, maxiter=maxiter, solve_method="batched")`` under
    ``vmap``: ``b``/``x0`` are tuples of ``(B, M_j)`` parts, ``A``/``M``
    map such tuples, every string has its own Krylov space and its own
    exits.

    Each restart runs ``restart`` Arnoldi steps (one classical Gram-Schmidt
    pass; a string stops at a breakdown, a new vector's norm at most eps
    times the matvec's) and solves the least-squares problem through the
    normal equations (Cholesky); restarts continue while a string's
    preconditioned residual exceeds ``tol * |b|``.
    """
    dt = b[0].dtype
    eps = torch.finfo(dt).eps
    B = b[0].shape[0]
    dev = b[0].device
    sub = lambda x, y: tuple(p - q for p, q in zip(x, y))
    atol = tol * _norm(b)
    unit, rnorm = _safe_normalize(M(sub(b, A(x0))), eps)
    x = x0
    live = torch.ones(B, dtype=torch.bool, device=dev)
    eye = torch.eye(restart, restart + 1, dtype=dt, device=dev)
    for _ in range(maxiter):
        live = live & (rnorm > atol)
        if not bool(live.any()):
            break
        # one restart (jax _gmres_batched): Krylov basis V (B, M_j, m+1)
        V = [torch.zeros(p.shape + (restart + 1,), dtype=dt, device=dev) for p in unit]
        for Vj, u in zip(V, unit):
            Vj[..., 0] = u
        H = eye.expand(B, restart, restart + 1).clone()
        going = live.clone()
        for kk in range(restart):
            if not bool(going.any()):
                break
            v = M(A(tuple(Vj[..., kk] for Vj in V)))
            _, n0 = _safe_normalize(v, eps)
            h = sum(torch.einsum("bmr,bm->br", Vj, p) for Vj, p in zip(V, v))
            v = tuple(p - torch.einsum("bmr,br->bm", Vj, h) for Vj, p in zip(V, v))
            unit_v, n1 = _safe_normalize(v, eps * n0)
            h[:, kk + 1] = n1
            g = going[:, None]
            for Vj, p in zip(V, unit_v):
                Vj[..., kk + 1] = torch.where(g, p, Vj[..., kk + 1])
            H[:, kk] = torch.where(g, h, H[:, kk])
            going = going & ~(n1 == 0.0)
        beta = torch.zeros((B, restart + 1), dtype=dt, device=dev)
        beta[:, 0] = rnorm
        # y = lstsq(H^T, beta) through (H H^T) y = H beta, as jax's _lstsq
        HT = H.transpose(1, 2)
        L, _ = torch.linalg.cholesky_ex(H @ HT)
        y = torch.cholesky_solve((H @ beta[:, :, None]), L)[:, :, 0]
        x_new = tuple(p + torch.einsum("bmr,br->bm", Vj[..., :-1], y)
                      for p, Vj in zip(x, V))
        unit_n, rnorm_n = _safe_normalize(M(sub(b, A(x_new))), eps)
        lv = live[:, None]
        x = tuple(torch.where(lv, p, q) for p, q in zip(x_new, x))
        unit = tuple(torch.where(lv, p, q) for p, q in zip(unit_n, unit))
        rnorm = torch.where(live, rnorm_n, rnorm)
    return x


def string_step(carry: Carry, xs, sp: StringParams, bp: BowParams,
                hp: HammerParams, bow_mask, hammer_mask, consts: SimConsts):
    """One theta-scheme time step (string.cpp:43-306).

    ``xs`` = ``(f0_n, x_b_n, v_b_n, F_b_n, wid_n, n_global)``: the per-step
    slices of the control signals and the global step index.  Returns
    ``(new_carry, out)``.
    """
    f0_n, x_b_n, v_b_n, F_b_n, wid_n, n_global = xs
    k, theta_t, lambda_c = consts.k, consts.theta_t, consts.lambda_c
    M_t, M_l = consts.M_t, consts.M_l
    dtype, dev = carry.u1.dtype, carry.u1.device

    gamma, K, N_t, h_t, N_l, h_l = get_derived_vars(
        f0_n, sp.kappa, k, theta_t, lambda_c, sp.alpha)
    sig0, sig1 = t60_to_sigma(sp.T60, gamma, K)
    tol_t = h_t**consts.relative_error
    tol_l = h_l**consts.relative_error
    n_t = N_t + 1.0  # live transverse points
    n_l = N_l + 1.0

    u1 = st.mask_live(carry.u1, n_t)
    u2 = st.mask_live(carry.u2, n_t)
    z1 = st.mask_live(carry.z1, n_l)
    z2 = st.mask_live(carry.z2, n_l)

    ht = h_t[:, None]
    hl = h_l[:, None]
    s0 = sig0[:, None]
    s1 = sig1[:, None]
    gamma_k = (gamma**2)[:, None] * k**2
    phi_pow = gamma_k * (sp.alpha**2 - 1.0)[:, None] / 4.0
    lam = st.dxb(u1, ht)  # Lambda = Dxb u1 (string.cpp:153)
    lam2 = lam * lam

    # ---- LHS tridiagonal coefficients ---------------------------------------
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    a_t = (1.0 - theta_t) / 2.0 - 2.0 * s1 * k / (ht * ht)
    b_t = theta_t + 2.0 * s0 * k + 4.0 * s1 * k / (ht * ht)
    d_next = st.shift(lam2, -1)
    idx_t = torch.arange(M_t, dtype=dtype, device=dev)[None, :]
    live_t = idx_t < n_t[:, None]
    sub_t = torch.where((idx_t >= 1) & live_t, a_t - phi_pow * lam2 / (ht * ht), zero)
    diag_t = torch.where(live_t, b_t + phi_pow * (lam2 + d_next) / (ht * ht), one)
    sup_t = torch.where(idx_t < (n_t[:, None] - 1.0), a_t - phi_pow * d_next / (ht * ht),
                        zero)
    a_l = -2.0 * s1 * k / (hl * hl)
    b_l = 1.0 + 2.0 * s0 * k + 4.0 * s1 * k / (hl * hl)
    idx_l = torch.arange(M_l, dtype=dtype, device=dev)[None, :]
    live_l = idx_l < n_l[:, None]
    sub_l = torch.where((idx_l >= 1) & live_l, a_l, zero)
    diag_l = torch.where(live_l, b_l, one)
    sup_l = torch.where(idx_l < (n_l[:, None] - 1.0), a_l, zero)

    # ---- cross-grid couplings as operators ----------------------------------
    def K_tl(zv):
        """A_2 = -phi_pow * Dxf_tt Lam Dxb_tt Int_tl (string.cpp:158)."""
        w = st.interp_linear(zv, n_l, n_t, M_t)
        return -phi_pow * st.dxf(lam * st.dxb(w, ht), ht)

    def K_lt(uv):
        """A_3 = -phi_pow * Dxf_ll Int_lt Lam Dxb_tt (string.cpp:159)."""
        w = st.interp_linear(lam * st.dxb(uv, ht), n_t, n_l, M_l)
        return -phi_pow * st.dxf(w, hl)

    # ---- constant part of the RHS (B w1 + C w2, string.cpp:162-170) ---------
    K2k2 = (K**2)[:, None] * k**2
    B1u1 = (-2.0 * st.theta_op(u1, theta_t) - gamma_k * st.dxx(u1, ht)
            + K2k2 * st.dxxxx_clamped(u1, ht, n_t))
    C1u2 = (st.theta_op(u2, theta_t) - 2.0 * s0 * k * u2
            + 2.0 * s1 * k * st.dxx(u2, ht) - phi_pow * st.dxf_diag_dxb(u2, lam2, ht))
    rhs_u_const = B1u1 + 2.0 * K_tl(z1) + C1u2 + K_tl(z2)
    alpha2 = (sp.alpha**2)[:, None]
    B4z1 = -2.0 * z1 - gamma_k * alpha2 * st.dxx(z1, hl)
    C4z2 = (1.0 - 2.0 * s0 * k) * z2 + 2.0 * s1 * k * st.dxx(z2, hl)
    rhs_z_const = B4z1 + K_lt(u2) + C4z2

    if consts.manufactured:
        t_now = (float(n_global) - (1.0 if consts.mms_centered else 0.0)) * k
        x_u = st.domain_x(M_t, N_t)
        f_u = mms_forcing(gamma, sig0, K, sp.p_a, x_u, t_now)
        x_z = torch.full((1, M_l), 0.5, dtype=dtype, device=dev)  # concat rows saturate
        f_z = mms_forcing(gamma, sig0, K, sp.p_a, x_z, t_now)
        rhs_u_const = rhs_u_const - f_u * k**2
        rhs_z_const = rhs_z_const - f_z * k**2

    # u rows live to N_t; z rows as the reference's concatenated-layout mask
    # (string.cpp:233): rows j with M_t + j + 1 <= N_t + N_l + 2
    z_keep = torch.minimum(torch.clamp(N_t + N_l + 2.0 - M_t, min=0.0), n_l)

    # ---- excitation profiles --------------------------------------------------
    h_mask = hammer_mask.to(dtype)
    b_mask = bow_mask.to(dtype)
    has_exc = consts.has_bow or consts.has_hammer
    if consts.has_bow:
        rc = st.raised_cosine(N_t - 1.0, x_b_n, wid_n * h_t, M_t)  # bow.cpp:32
    if consts.has_hammer:
        eps_prof = st.floor_dirac_delta(N_t - 1.0, hp.x_H, M_t)  # hammer.cpp:71
        M_r = hp.M_r / lambda_c
        w_H = hp.w_H / lambda_c
        eta_1 = carry.uH1 - torch.sum(eps_prof * u1, dim=-1)
        eta_2 = carry.uH2 - torch.sum(eps_prof * u2, dim=-1)

    rhs_z = st.mask_live(rhs_z_const, z_keep)
    inner_eps = consts.coupling_eps_factor * torch.finfo(dtype).eps

    def finish(u_n, z_n):
        return (st.dirichlet(st.mask_live(u_n, n_t), N_t),
                st.dirichlet(st.mask_live(z_n, n_l), N_l))

    def coupled_solve(rhs_u, u0_i, z0_i):
        """The cross-coupled block system to machine precision (the
        reference's joint dense inverse, string.cpp:173-175, 238)."""
        if consts.coupling_solver == "gmres":
            def mv(x):
                u_x, z_x = x
                return (tridiag_matvec(sub_t, diag_t, sup_t, u_x) + K_tl(z_x),
                        tridiag_matvec(sub_l, diag_l, sup_l, z_x) + K_lt(u_x))

            def prec(r):
                r_u, r_z = r
                u_p = tridiag_solve(sub_t, diag_t, sup_t, r_u)
                return u_p, tridiag_solve(sub_l, diag_l, sup_l, r_z - K_lt(u_p))

            u_n, z_n = gmres(
                mv, (-rhs_u, -rhs_z), (u0_i, z0_i), prec,
                tol=float(consts.coupling_eps_factor) * float(torch.finfo(dtype).eps),
                restart=min(16, M_t + M_l),
                maxiter=max(consts.coupling_max_iter // 16, 2))
            return finish(u_n, z_n)
        if consts.coupling_fixed_iters > 0:
            u_n, z_n = u0_i, z0_i
            for _ in range(consts.coupling_fixed_iters):
                u_n = tridiag_solve(sub_t, diag_t, sup_t, -rhs_u - K_tl(z_n))
                z_n = tridiag_solve(sub_l, diag_l, sup_l, -rhs_z - K_lt(u_n))
            return finish(u_n, z_n)
        # adaptive damped Gauss-Seidel: omega halves (floor 1/16) wherever
        # the undamped displacement grows; batch-wide exit, a NaN or
        # hopeless string reads as done
        B = u0_i.shape[0]
        u_i, z_i = u0_i, z0_i
        omega = torch.ones(B, dtype=dtype, device=dev)
        prev = torch.full((B,), math.inf, dtype=dtype, device=dev)
        hopeless = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(max(consts.coupling_max_iter, 1)):
            u_g = tridiag_solve(sub_t, diag_t, sup_t, -rhs_u - K_tl(z_i))
            z_g = tridiag_solve(sub_l, diag_l, sup_l, -rhs_z - K_lt(u_g))
            u_n = u_i + omega[:, None] * (u_g - u_i)
            z_n = z_i + omega[:, None] * (z_g - z_i)
            # the undamped displacement measures the distance to the fixed
            # point whatever omega is
            delta = (torch.amax(torch.abs(u_g - u_i), dim=-1)
                     + torch.amax(torch.abs(z_g - z_i), dim=-1))
            grew = delta > prev
            hopeless = grew & (omega <= 0.0625)
            omega = torch.where(grew, torch.clamp(omega * 0.5, min=0.0625), omega)
            scale_b = torch.amax(torch.abs(u_n), dim=-1) + inner_eps
            live_err = (delta > inner_eps * scale_b) & ~hopeless
            u_i, z_i, prev = u_n, z_n, delta
            if not bool(live_err.any()):
                break
        # a string still growing at the relaxation floor is poisoned, so the
        # NaN skip and rescue machinery sees it
        u_i = torch.where(hopeless[:, None], torch.full_like(u_i, math.nan), u_i)
        return finish(u_i, z_i)

    def free_hammer_state():
        """Hammer displacement advance with zero force (hammer.cpp:43-45)."""
        u_H = 2.0 * carry.uH1 - carry.uH2
        return torch.clamp(u_H - M_HD_CLAMP, min=0.0) + M_HD_CLAMP

    zeros_b = torch.zeros_like(carry.uH1)
    if not has_exc:
        # the RHS cannot change between Picard iterates: solve once
        u, z = coupled_solve(st.mask_live(rhs_u_const, n_t), carry.u1, carry.z1)
        v_rel = F_H = zeros_b
        u_H = free_hammer_state()
        n_iter = 1
    else:
        u, z = carry.u1, carry.z1
        v_rel = F_H = u_H = zeros_b
        conv = torch.zeros(u.shape[0], dtype=torch.bool, device=dev)
        n_iter = 0
        while n_iter == 0 or (not bool(conv.all()) and n_iter < consts.picard_max_iter):
            rhs_u = rhs_u_const
            v_rel_n, F_H_n, u_H_n = v_rel, F_H, u_H
            if consts.has_bow:  # bow.cpp:17-41
                du = (u1 - u2) if n_iter == 0 else (u - u1)
                v_rel_n = torch.sum(rc * (du / k - v_b_n[:, None]), dim=-1)
                phi = hard_bow(v_rel_n, bp.phi_0, bp.phi_1)
                G_B = -(k**2) * (rc / ht) * (F_b_n * phi)[:, None]
                rhs_u = rhs_u + b_mask[:, None] * torch.nan_to_num(G_B)
            if consts.has_hammer:  # hammer.cpp:56-85
                eps_u = torch.sum(eps_prof * u, dim=-1)
                F_H_n, u_H_n = _hammer_loop(
                    carry.uH1, carry.uH2, eta_1, eta_2, hp.alpha, w_H, eps_u, k,
                    tol_t, h_mask, consts.hammer_max_iter)
                G_H = -(k**2) * eps_prof * (M_r * F_H_n)[:, None]
                rhs_u = rhs_u + h_mask[:, None] * torch.nan_to_num(G_H)
            else:
                u_H_n = free_hammer_state()
            u_new, z_new = coupled_solve(st.mask_live(rhs_u, n_t), u, z)
            # a string that converged before this iteration keeps its state
            # and probe values (the reference iterates the whole batch on a
            # global any(); the fixed point is the same)
            fz = conv[:, None]
            u_new = torch.where(fz, u, u_new)
            z_new = torch.where(fz, z, z_new)
            v_rel = torch.where(conv, v_rel, v_rel_n)
            F_H = torch.where(conv, F_H, F_H_n)
            u_H = torch.where(conv, u_H, u_H_n)
            res_u = torch.amax(torch.abs(u - u_new), dim=-1)
            res_z = torch.amax(torch.abs(z - z_new), dim=-1)
            # a NaN residual reads as converged and frozen
            conv = conv | ~((res_u > tol_t) | (res_z > tol_l))
            u, z = u_new, z_new
            n_iter += 1

    # ---- readout (string.cpp:263-298) ------------------------------------------
    rp = sp.pos
    if consts.surface_integral:
        w_out = 0.5 * h_t * (1.0 + h_mask + b_mask)
        u_out = torch.sum(u - carry.u1, dim=-1) * w_out / k
        z_out = torch.sum(z - carry.z1, dim=-1) * w_out / k
    else:
        u_ri = 1.0 + torch.floor(N_t * rp)
        z_ri = 1.0 + torch.floor(N_l * rp)
        u_f = 1.0 + rp / h_t - u_ri
        z_f = 1.0 + rp / h_l - z_ri

        def take(arr, i, M):
            i = torch.clamp(i.long(), 0, M - 1)[:, None]
            return torch.gather(arr, -1, i)[:, 0]

        u_out = (1.0 - u_f) * take(u, u_ri, M_t) + u_f * take(u, u_ri + 1, M_t)
        z_out = (1.0 - z_f) * take(z, z_ri, M_l) + z_f * take(z, z_ri + 1, M_l)

    new_carry = Carry(u1=u, u2=carry.u1, z1=z, z2=carry.z1, uH1=u_H, uH2=carry.uH1)
    out = {"uout": u_out, "zout": z_out, "v_r": v_rel, "F_H": F_H, "u_H": u_H,
           "sig0": sig0, "sig1": sig1, "n_iter": n_iter}
    if consts.collect_state:
        out["u"] = u
        out["z"] = z
    return new_carry, out


@torch.inference_mode()
def simulate_chunk(carry: Carry, steps, sp: StringParams, bp: BowParams,
                   hp: HammerParams, bow_mask, hammer_mask, consts: SimConsts):
    """Run :func:`string_step` over the global step indices ``steps`` (the
    reference iterates n = 2..Nt per chunk with global index n + n_0,
    simulator.cpp:40-45); the control signals are read per step from the
    full ``(B, Nt)`` arrays.  Returns ``(carry, out)`` with every entry of
    ``out`` stacked over the steps on a leading axis, as ``lax.scan``
    stacks them (``n_iter`` a ``(T,)`` int tensor)."""
    outs = []
    for n in [int(n) for n in steps]:
        xs = (sp.f0[:, n], bp.x_b[:, n], bp.v_b[:, n], bp.F_b[:, n], bp.wid[:, n], n)
        carry, out = string_step(carry, xs, sp, bp, hp, bow_mask, hammer_mask, consts)
        outs.append(out)
    stacked = {key: torch.stack([o[key] for o in outs])
               for key in outs[0] if key != "n_iter"}
    stacked["n_iter"] = torch.tensor([o["n_iter"] for o in outs], dtype=torch.int32)
    return carry, stacked
