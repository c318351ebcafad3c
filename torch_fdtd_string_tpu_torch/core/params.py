"""Virtual-instrument parameter sampling (host side).

Functional re-implementation of the reference's ``String``/``Bow``/``Hammer``
``nn.Module`` samplers (``src/model/simulator.py``) on numpy: sampling happens
once per batch on the host.  Distributional semantics follow the reference
exactly (uniform ranges, normal-threshold masks, Fletcher f0 pre-correction,
velocity-weighted hammer mass sampling, ...).

This is the PyTorch port's copy of ``torch_fdtd_string_tpu/core/params.py``.
It draws from the same numpy ``Generator`` calls in the same order, so one
seed gives bit-identical parameters in both packages; the only departure is
that the grid-sizing dtype follows the explicit ``precision`` argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..ops import fdm

M_HD_INIT = -1e-3  # reference simulator.py:507 (hammer buffer init constant)


# -----------------------------------------------------------------------------
# control signals (reference src/utils/control.py)
# -----------------------------------------------------------------------------

def constant(f0, n):
    """(B,) -> (B, n) constant trajectory."""
    return np.repeat(np.asarray(f0)[:, None], n, axis=1)


def linear(f1, f2, n):
    """(B,) x (B,) -> (B, n) linear glide (align_corners interpolation)."""
    w = np.linspace(0.0, 1.0, n)[None, :]
    return np.asarray(f1)[:, None] * (1 - w) + np.asarray(f2)[:, None] * w


def vibrato(rng, f0, k, mf=(3.0, 5.0), ma=0.05, ma_in_hz=False):
    """Random-onset vibrato (control.py:26-45)."""
    B, n = f0.shape
    mod_frq = mf[1] * rng.random((B, 1)) + mf[0]
    mod_amp = ma * rng.random((B, 1))
    vt = np.floor((n // 2) * rng.random((B, 1)))
    t = np.arange(1, n + 1)[None, :].astype(f0.dtype)
    m = t > vt
    vibra = m * mod_amp * (1 - np.cos(2 * np.pi * mod_frq * (t - vt) * k)) / 2
    if not ma_in_hz:
        vibra = vibra * f0
    sign = np.sign(rng.standard_normal((B, 1)))
    sign[sign == 0] = 1.0
    return f0 + vibra * sign


def glissando(f1, f2, n, mode="linear"):
    """Pitch glide between two anchors (control.py:20-24)."""
    if mode != "linear":
        raise NotImplementedError(mode)
    return linear(f1, f2, n)


def triangle_with_velocity(vel, n, sr_t, sr_x, max_u=0.1):
    """Triangular hammer-displacement profile from a strike velocity
    (control.py:47-58). vel: (B,); returns (B, n)."""
    vel = np.asarray(vel, float).reshape(-1, 1) * sr_x / sr_t
    ramp = vel * np.arange(1, n + 1)[None, :]
    u_H = np.maximum(max_u - np.abs(max_u - ramp) - vel, 0.0)
    return np.clip(u_H**5, None, 0.01)


def pre_shaper(x, sr, velocity=10):
    """tanh attack envelope (misc.py:74-76)."""
    n = x.shape[-1]
    w = np.tanh(np.arange(1, n + 1) / sr * velocity)
    return w[None, :] * x if x.ndim > 1 else w * x


def post_shaper(x, sr, pulloff, velocity=100):
    """tanh release envelope starting at ``pulloff`` seconds (misc.py:78-82)."""
    n = x.shape[-1]
    offset = n - int(sr * pulloff)
    w = np.tanh(np.arange(1, n + 1) / sr * velocity)[::-1]
    w = np.concatenate([w[offset:], np.zeros(offset)])
    return w * x


def equidistant(lo, hi, steps):
    return np.linspace(lo, hi, steps)


def triangular_np(M, n, p_x, p_a):
    """Numpy twin of ``stencils.triangular`` (misc.py:60-72).

    n, p_x, p_a: broadcastable (B,) arrays; returns (B, M).
    """
    n = np.asarray(n, dtype=float)[:, None]
    p_x = np.asarray(p_x, dtype=float)[:, None]
    p_a = np.asarray(p_a, dtype=float)[:, None]
    i = np.arange(M, dtype=float)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        vel_l = np.where(p_x <= 0, 0.0, p_a / np.where(p_x <= 0, 1.0, p_x) / n)
        vel_r = np.where(p_x <= 0, 0.0, p_a / np.where(p_x <= 0, 1.0, 1.0 - p_x) / n)
    left = np.maximum(vel_l * i, 0.0)
    right = np.maximum(vel_r * (n - 1.0 - i), 0.0)
    return np.minimum(left, right)


def raised_cosine_np(N, h, ctr, wid, n):
    """Numpy twin of the *python* raised cosine (misc.py:36-48).

    Note: differs from the C++ one — ``wid`` is scaled by ``1/N`` only.
    ctr, wid, n: (B,) arrays. Returns (B, N).
    """
    ctr = np.asarray(ctr, dtype=float)[:, None]
    wid = np.asarray(wid, dtype=float)[:, None]
    n = np.asarray(n, dtype=float)[:, None]
    xax = np.linspace(h, 1.0, N)[None, :]
    c = ctr * n / N
    w = wid / N
    ind = np.sign(np.maximum(-(xax - c - w / 2) * (xax - c + w / 2), 0.0))
    out = 0.5 * ind * (1 + np.cos(2 * np.pi * (xax - c) / w))
    s = np.abs(out).sum(axis=1, keepdims=True)
    return out / np.where(s == 0, 1.0, s)


def get_masks(rng, model_name, bs, disjoint=True):
    """Excitation-type masks (misc.py:95-121). Returns bool (B,) arrays."""
    if model_name.endswith("bow"):
        bow = np.ones(bs, bool)
        hammer = np.zeros(bs, bool)
    elif model_name.endswith("hammer"):
        bow = np.zeros(bs, bool)
        hammer = np.ones(bs, bool)
    elif model_name.endswith("pluck"):
        bow = np.zeros(bs, bool)
        hammer = np.zeros(bs, bool)
    else:
        bow = rng.random(bs) > 0.5
        hammer = rng.random(bs) > 0.5
        if disjoint:
            hammer = np.where(bow, False, hammer)
    return bow, hammer


# -----------------------------------------------------------------------------
# sampled parameter bundles
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class StringState:
    """Sampled string parameters + initial field rows.

    Mirrors the buffers of reference ``String`` (simulator.py:11-390).
    """

    kappa: np.ndarray  # (B,)
    alpha: np.ndarray  # (B,)
    u0: np.ndarray  # (B, M_t) initial displacement profile (t = 0 row)
    v0: np.ndarray  # (B, M_t) initial velocity profile
    p_a: np.ndarray  # (B,) max pluck amplitude
    f0: np.ndarray  # (B, Nt) simulation input f0 (after precorrection)
    pos: np.ndarray  # (B,) pickup position
    T60: np.ndarray  # (B, 2, 2)
    target_f0: np.ndarray  # (B, Nt) intended output f0
    Nx_t: int  # padded transverse intervals
    Nx_l: int  # padded longitudinal intervals


@dataclasses.dataclass
class BowState:
    x_b: np.ndarray  # (B, Nt)
    v_b: np.ndarray  # (B, Nt)
    F_b: np.ndarray  # (B, Nt)
    phi_0: np.ndarray  # (B,)
    phi_1: np.ndarray  # (B,)
    wid: np.ndarray  # (B, Nt)


@dataclasses.dataclass
class HammerState:
    x_H: np.ndarray  # (B,)
    v_H: np.ndarray  # (B, Nt)
    u_H: np.ndarray  # (B, Nt) initial hammer displacement buffer rows
    w_H: np.ndarray  # (B,)
    M_r: np.ndarray  # (B,)
    alpha: np.ndarray  # (B,)


def _rand(rng, lo, hi, size, randomize_each="batch", weight=None, dtype=np.float64):
    """random_uniform with batch/iter semantics (simulator.py:89-96)."""
    if weight is None:
        weight = np.ones(size, dtype)
    if randomize_each == "batch":
        u = rng.random(size)
    else:
        u = np.broadcast_to(rng.random(1), size)
    return ((hi - lo) * u * weight + lo).astype(dtype)


def sample_string(
    rng: np.random.Generator,
    *,
    k: float,
    theta_t: float,
    lambda_c: float,
    sr: int,
    length: float,
    f0_inf: float,
    alpha_inf: float,
    batch_size: int,
    precision: str = "single",
    pluck_batch=False,
    pluck_mask: Optional[np.ndarray] = None,
    hammer_mask: Optional[np.ndarray] = None,
    randomize_each: str = "batch",
    manufactured: bool = False,
    # string condition (simulator.py:114-136 defaults)
    sampling_f0: str = "random",
    sampling_kappa: str = "random",
    sampling_alpha: str = "random",
    sampling_pickup: str = "random",
    sampling_T60: str = "random",
    precorrect: bool = True,
    f0_min: float = 27.50,
    f0_max: float = 440.0,
    f0_diff_max: float = 50.0,
    f0_mod_max: float = 0.02,
    f0_fixed=20.0,
    kappa_min: float = 0.0,
    kappa_max: float = 0.08,
    kappa_fixed: float = 0.08,
    kappa_hammer: float = 0.0,
    alpha_min: float = 1.0,
    alpha_max: float = 25.0,
    alpha_fixed: float = 3.0,
    pos_min: float = 0.3,
    pos_max: float = 0.7,
    pos_fixed: float = 0.5,
    lossless: bool = False,
    t60_min_1: float = 20.0,
    t60_max_1: float = 30.0,
    t60_min_2: float = 30.0,
    t60_max_2: float = 30.0,
    t60_fixed: float = 20.0,
    t60_diff_max: float = 5.0,
    sampling_p_a: str = "random",
    sampling_p_x: str = "random",
    p_a_min: float = 0.001,
    p_a_max: float = 0.01,
    p_a_fixed: float = 0.01,
    p_x_min: float = 0.100,
    p_x_max: float = 0.90,
    p_x_fixed: float = 0.50,
    pluck_profile: Optional[str] = None,
) -> StringState:
    assert precision in ("single", "double")
    dtype = np.float64 if precision == "double" else np.float32
    assert alpha_inf >= 1
    Bs = batch_size
    Nt = int(sr * length)
    if pluck_profile is None:
        pluck_profile = "triangular"
    assert pluck_profile in ("triangular", "smooth", "raised_cosine")

    rb = lambda lo, hi, size=(Bs,), w=None: _rand(
        rng, lo, hi, size, randomize_each, w, dtype
    )

    if pluck_mask is None:
        pluck_mask = np.zeros(Bs, bool)
    if hammer_mask is None:
        hammer_mask = np.zeros(Bs, bool)

    # --- kappa (simulator.py:281-295) ---
    if sampling_kappa == "random":
        kappa_r = rb(kappa_min, kappa_max)
        kappa = np.where(hammer_mask, kappa_hammer + kappa_r, kappa_r)
    elif sampling_kappa == "equidist":
        kappa = equidistant(kappa_min, kappa_max, Bs).astype(dtype)
    else:
        kappa = np.full(Bs, kappa_fixed, dtype)

    # --- f0 (simulator.py:205-279) ---
    if sampling_f0 == "random":
        f0_con = constant(rb(f0_min, f0_max), Nt)
        f0_1 = rb(f0_min, f0_max)
        f0_2 = np.clip(rb(f0_min, f0_max), f0_1 - f0_diff_max, f0_1 + f0_diff_max)
        f0_lin = linear(f0_1, f0_2, Nt)
        tv_th = 0.5 if randomize_each == "batch" else 2.0
        tv = (rng.standard_normal(Bs) >= tv_th)[:, None]
        f0 = np.where(tv, f0_lin, f0_con)
        vb_m = (rng.standard_normal(Bs) >= tv_th)[:, None]
        vb = vibrato(rng, f0, 1.0 / sr, mf=(3.0, 5.0), ma=f0_mod_max)
        f0 = np.where(vb_m, f0, vb)
        # Divergence from the reference (simulator.py:230-235): vibrato on a
        # string near f0_min can dip the curve below f0_inf, which the
        # reference then *crashes* on at its :277 assert (the static grid
        # bound would be violated).  Clamp the trough instead — the grid
        # invariant is what matters; a flattened vibrato low on the lowest
        # strings is physically benign.
        f0 = np.maximum(f0, np.asarray(f0_inf, dtype))
    elif sampling_f0 == "equidist":
        f0 = constant(equidistant(f0_min, f0_max, Bs), Nt)
    else:  # fixed (scalar or per-batch list)
        if np.ndim(f0_fixed) > 0 and len(np.atleast_1d(f0_fixed)) > 1:
            vals = np.asarray(list(f0_fixed), dtype)[:, None]
            min_fixed = float(vals.min())
        else:
            vals = float(np.atleast_1d(f0_fixed)[0])
            min_fixed = vals
        assert min_fixed >= f0_inf, f"f0_fixed {min_fixed} < f0_inf {f0_inf}"
        f0 = vals * np.ones((Bs, Nt), dtype)
    f0 = f0.astype(dtype)
    target_f0 = f0.copy()

    # --- alpha (simulator.py:297-307) ---
    if sampling_alpha == "random":
        alpha = rb(alpha_min, alpha_max)
    elif sampling_alpha == "equidist":
        alpha = equidistant(alpha_min, alpha_max, Bs).astype(dtype)
    else:
        af = alpha_inf if alpha_fixed < alpha_inf else alpha_fixed
        alpha = np.full(Bs, af, dtype)
    assert (alpha >= alpha_inf).all()

    # --- precorrection (simulator.py:264-277, README "f0 precorrection") ---
    var = fdm.get_derived_vars_np(f0_inf, 0.0, k, theta_t, lambda_c, alpha_inf)
    Nx_t, Nx_l = var[2], var[4]
    if precorrect:
        w0 = np.asarray(fdm.stiff_string_modes(0.0, kappa.reshape(-1, 1), 1)[1][0])
        w0_max = float(w0.max())
        f0_inf_eff = f0_inf / w0_max
        var = fdm.get_derived_vars_np(f0_inf_eff, 0.0, k, theta_t, lambda_c, alpha_inf)
        Nx_t, Nx_l = var[2], var[4]
        f0 = (f0 / w0).astype(dtype)
        f0_inf = f0_inf_eff
    assert f0.min() >= f0_inf, (f0.min(), f0_inf)

    # --- pickup (simulator.py:348-355) ---
    if sampling_pickup == "random":
        pos = rb(pos_min, pos_max)
    elif sampling_pickup == "equidist":
        pos = equidistant(pos_min, pos_max, Bs).astype(dtype)
    else:
        pos = np.full(Bs, pos_fixed, dtype)

    # --- T60 (simulator.py:357-390) ---
    if sampling_T60 == "random":
        T60_freq_min = (1 / 240) * sr / 2
        T60_freq_max = (1 / 4) * sr / 2
        T60_freq_1 = rb(T60_freq_min + 1000, T60_freq_max)
        T60_freq_2 = rb(T60_freq_min, 1.0)  # placeholder; recompute below
        # reference: random in [T60_freq_min, T60_freq_1 - 1000] per element
        u = rng.random(Bs) if randomize_each == "batch" else np.broadcast_to(rng.random(1), (Bs,))
        T60_freq_2 = (T60_freq_1 - 1000 - T60_freq_min) * u + T60_freq_min
        T60_time_1 = rb(t60_min_1, t60_max_1)
        T60_time_2 = np.clip(T60_time_1 + rb(0, t60_diff_max), t60_min_2, t60_max_2)
        assert (T60_time_1 <= T60_time_2).all()
    elif sampling_T60 == "equidist":
        T60_freq_1 = np.full(Bs, 1000.0, dtype)
        T60_freq_2 = np.full(Bs, 100.0, dtype)
        t1 = equidistant(t60_min_1, t60_max_1, Bs - 1)
        t2 = equidistant(t60_min_2, t60_max_2, Bs - 1)
        T60_time_1 = np.concatenate([t1, [0.0]]).astype(dtype)
        T60_time_2 = np.concatenate([t2, [0.0]]).astype(dtype)
    elif lossless:
        T60_freq_1 = np.full(Bs, 1000.0, dtype)
        T60_freq_2 = np.full(Bs, 100.0, dtype)
        T60_time_1 = np.zeros(Bs, dtype)
        T60_time_2 = np.zeros(Bs, dtype)
    else:
        T60_freq_1 = np.full(Bs, 1000.0, dtype)
        T60_freq_2 = np.full(Bs, 100.0, dtype)
        T60_time_1 = np.full(Bs, t60_fixed, dtype)
        T60_time_2 = np.full(Bs, t60_fixed, dtype)
    T60 = np.stack(
        [
            np.stack([T60_freq_1, T60_time_1], axis=-1),
            np.stack([T60_freq_2, T60_time_2], axis=-1),
        ],
        axis=1,
    ).astype(dtype)

    # --- pluck amplitude/position (simulator.py:310-346) ---
    if pluck_batch is True:
        plucked = np.ones(Bs, bool)
    elif pluck_batch is False:
        plucked = np.zeros(Bs, bool)
    else:  # None -> per-element pluck mask
        plucked = pluck_mask.astype(bool)

    if sampling_p_a == "random":
        p_a_s = rb(p_a_min, p_a_max)
    elif sampling_p_a == "equidist":
        p_a_s = equidistant(p_a_min, p_a_max, Bs).astype(dtype)
    else:
        p_a_s = np.full(Bs, p_a_fixed, dtype)
    if sampling_p_x == "random":
        p_x_s = rb(p_x_min, p_x_max)
    elif sampling_p_x == "equidist":
        p_x_s = equidistant(p_x_min, p_x_max, Bs).astype(dtype)
    else:
        p_x_s = np.full(Bs, p_x_fixed, dtype)
    p_a_s = np.where(plucked, p_a_s, 0.0).astype(dtype)
    p_x_s = np.where(plucked, p_x_s, 0.0).astype(dtype)

    # --- initial displacement profile (simulator.py:170-203) ---
    f0_b = f0.min(axis=-1)
    # grid sizing runs in the run's precision (the JAX package reads its
    # x64 flag here; a double-precision run there has it on)
    _gd_dt = np.float64 if precision == "double" else np.float32
    nx_t = np.floor(
        np.asarray(
            fdm.get_derived_vars_host(
                f0_b, kappa, k, theta_t, lambda_c, alpha, dtype=_gd_dt
            )[2]
        )
    ).astype(dtype)
    M_t = Nx_t + 1
    if manufactured:
        p_x_m = np.sign(p_x_s) * 0.5
        tr = triangular_np(M_t, nx_t + 1, p_x_m, np.ones(Bs)) - 1.0
        u0 = p_a_s[:, None] * np.cos(np.pi * tr / 2.0) ** 2
    elif pluck_profile == "triangular":
        u0 = triangular_np(M_t, nx_t + 1, p_x_s, p_a_s)
    elif pluck_profile == "smooth":
        tr = triangular_np(M_t, nx_t + 1, p_x_s, np.ones(Bs))
        u0 = p_a_s[:, None] * np.sin(tr * np.pi / 2.0) ** 2
    else:  # raised_cosine
        rc = raised_cosine_np(
            M_t, 1.0 / Nx_t, p_x_s, np.floor_divide(nx_t, 10), nx_t + 1
        )
        u0 = rc * np.sign(p_x_s)[:, None]
    u0 = u0.astype(dtype)
    v0 = np.zeros_like(u0)
    p_a_out = np.abs(u0).max(axis=-1).astype(dtype)

    return StringState(
        kappa=kappa,
        alpha=alpha,
        u0=u0,
        v0=v0,
        p_a=p_a_out,
        f0=f0,
        pos=pos,
        T60=T60,
        target_f0=target_f0,
        Nx_t=Nx_t,
        Nx_l=Nx_l,
    )


def sample_bow(
    rng: np.random.Generator,
    *,
    sr: int,
    length: float,
    batch_size: int,
    precision: str = "single",
    randomize_each: str = "batch",
    x_b_min: float = 0.2,
    x_b_max: float = 0.5,
    x_b_maxdiff: float = 0.2,
    v_b_min: float = 0.3,
    v_b_max: float = 0.4,
    F_b_min: float = 80.0,
    F_b_max: float = 100.0,
    F_b_maxdiff: float = 10.0,
    do_pulloff: bool = True,
    phi_0_max: float = 6.0,
    phi_0_min: float = 2.0,
    phi_1_max: float = 0.5,
    phi_1_min: float = 0.0,
    wid_min: float = 3.0,
    wid_max: float = 6.0,
) -> BowState:
    dtype = np.float64 if precision == "double" else np.float32
    Bs = batch_size
    Nt = int(sr * length)
    rb = lambda lo, hi, size=(Bs,): _rand(rng, lo, hi, size, randomize_each, None, dtype)

    x_1 = rb(x_b_min, x_b_max)
    x_2 = np.clip(x_1 + rb(-x_b_maxdiff, x_b_maxdiff), x_b_min, x_b_max)
    x_b = linear(x_1, x_2, Nt).astype(dtype)

    v_b = linear(rb(v_b_min, v_b_max), rb(v_b_min, v_b_max), Nt)
    v_b = pre_shaper(v_b, sr).astype(dtype)

    F_1 = rb(F_b_min, F_b_max)
    F_2 = F_1 + np.clip(rb(-F_b_maxdiff, F_b_maxdiff), F_b_min, F_b_max)
    F_b = linear(F_1, F_2, Nt)
    if do_pulloff:
        for b in range(Bs):
            if rng.random() > 0.5:
                pulloff = (3 * length / 4) * rng.random() + (length / 4)
                F_b[b] = post_shaper(F_b[b], sr, pulloff)
    F_b = F_b.astype(dtype)

    phi_0 = ((phi_0_max - phi_0_min) * rng.random(Bs) + phi_0_min).astype(dtype)
    phi_1 = ((phi_1_max - phi_1_min) * rng.random(Bs) + phi_1_min).astype(dtype)
    wid = constant(rb(wid_min, wid_max), Nt).astype(dtype)
    return BowState(x_b=x_b, v_b=v_b, F_b=F_b, phi_0=phi_0, phi_1=phi_1, wid=wid)


def sample_hammer(
    rng: np.random.Generator,
    *,
    sr: int,
    length: float,
    batch_size: int,
    precision: str = "single",
    k: float,
    randomize_each: str = "batch",
    x_H_min: float = 0.1,
    x_H_max: float = 0.9,
    v_H_min: float = 0.5,
    v_H_max: float = 5.0,
    M_r_min: float = 10.0,
    M_r_max: float = 50.0,
    w_H_min: float = 1000.0,
    w_H_max: float = 3000.0,
    alpha_fixed=None,
) -> HammerState:
    dtype = np.float64 if precision == "double" else np.float32
    Bs = batch_size
    Nt = int(sr * length)
    rb = lambda lo, hi, size=(Bs,), w=None: _rand(rng, lo, hi, size, randomize_each, w, dtype)

    x_H = rb(x_H_min, x_H_max)

    # velocity profile: impulse at sample 1 (simulator.py:570-581)
    v_H_amp = rb(v_H_min, v_H_max)
    profile = np.zeros((1, Nt), dtype)
    profile[:, 1] = 1.0
    v_H = v_H_amp[:, None] * profile
    u_H = np.zeros_like(v_H)
    u_H[:, :2] += M_HD_INIT
    u_H = u_H + k * v_H

    # velocity-weighted mass ratio (simulator.py:583-587)
    w = (
        None
        if v_H_max == v_H_min
        else 1.0 - (v_H.max(axis=-1) - v_H_min) / (v_H_max - v_H_min)
    )
    M_r = rb(M_r_min, M_r_max, (Bs,), w)

    w_H = rb(w_H_min, w_H_max)
    if alpha_fixed is None:
        alpha = (2 * (rb(0.0, 1.0) >= 0.5) + 1).astype(dtype)
    else:
        alpha = np.full(Bs, alpha_fixed, dtype)
    return HammerState(x_H=x_H, v_H=v_H, u_H=u_H, w_H=w_H, M_r=M_r, alpha=alpha)


def state_from_numpy(string=None, bow=None, hammer=None):
    """Copy parameter bundles into this package's containers.

    Each argument is any object with the fields of :class:`StringState`,
    :class:`BowState` or :class:`HammerState` holding numpy arrays (such as
    the JAX package's bundles of the same names); ``None`` stays ``None``.
    Arrays are copied, integer grid sizes kept.  Returns
    ``(string, bow, hammer)``.
    """

    def convert(obj, cls):
        if obj is None:
            return None
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            kw[f.name] = int(v) if f.type == "int" else np.array(v, copy=True)
        return cls(**kw)

    return (
        convert(string, StringState),
        convert(bow, BowState),
        convert(hammer, HammerState),
    )
