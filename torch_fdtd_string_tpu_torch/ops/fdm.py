"""Finite-difference-scheme derived quantities for the planar stiff string.

PyTorch port of ``torch_fdtd_string_tpu/ops/fdm.py``.  Functions that the
JAX package runs on the host stay numpy (``get_derived_vars_np``,
``get_derived_vars_host``, ``grid_widths_np``, ``get_theta``); the per-step
device math (``get_derived_vars``, ``t60_to_sigma``) takes torch tensors.

Notation (Bilbao, *Numerical Sound Synthesis*, ch. 7):
  * ``gamma``   -- scaled wave speed, ``2 * f0`` (non-dimensional domain).
  * ``K``       -- stiffness constant, ``kappa_rel * gamma``.
  * ``theta_t`` -- free parameter of the implicit theta scheme (in (1/2, 1)).
  * ``N_t``     -- number of transverse grid intervals, ``h_t = 1 / N_t``.
  * ``N_l``     -- number of longitudinal grid intervals, ``h_l = 1 / N_l``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LN10_6 = float(6.0 * np.log(10.0))


class DerivedVars(NamedTuple):
    gamma: object
    K: object
    N_t: object
    h_t: object
    N_l: object
    h_l: object


def get_derived_vars(f0, kappa_rel, k, theta_t, lambda_c, alpha) -> DerivedVars:
    """Map (f0, kappa_rel, k, theta, lambda_c, alpha) -> grid geometry.

    Torch twin of the JAX ``get_derived_vars`` (reference ``string.cpp:16-41``),
    with the same few-ULP guard before ``floor``.  Tensor inputs broadcast.
    """
    gamma = 2.0 * f0
    K = kappa_rel * gamma
    two_t = 2.0 * theta_t - 1.0
    h_1 = lambda_c * torch.sqrt(
        (gamma**2 * k**2 + torch.sqrt(gamma**4 * k**4 + 16.0 * K**2 * k**2 * two_t))
        / (2.0 * two_t)
    )
    eps4 = 4.0 * torch.finfo(h_1.dtype).eps
    N_t = torch.floor((1.0 / h_1) * (1.0 + eps4))
    h_t = 1.0 / N_t
    h_2 = lambda_c * gamma * alpha * k
    N_l = torch.floor((1.0 / h_2) * (1.0 + eps4))
    h_l = 1.0 / N_l
    return DerivedVars(gamma, K, N_t, h_t, N_l, h_l)


def get_derived_vars_np(f0, kappa_rel, k, theta_t, lambda_c, alpha):
    """Scalar twin used to size the static padded grids (reference
    ``simulator.py:31-38``)."""
    gamma = 2.0 * f0
    K = kappa_rel * gamma
    two_t = 2.0 * theta_t - 1.0
    h_1 = lambda_c * math.sqrt(
        (gamma**2 * k**2 + math.sqrt(gamma**4 * k**4 + 16.0 * K**2 * k**2 * two_t))
        / (2.0 * two_t)
    )
    N_t = int(1.0 / h_1)
    h_2 = lambda_c * gamma * alpha * k
    N_l = int(1.0 / h_2)
    return gamma, K, N_t, 1.0 / max(N_t, 1), N_l, 1.0 / max(N_l, 1)


def get_derived_vars_host(f0, kappa_rel, k, theta_t, lambda_c, alpha,
                          dtype=np.float32):
    """Vectorized numpy twin of :func:`get_derived_vars`, computed in
    ``dtype`` with the same epsilon-guarded floor."""
    dt = np.dtype(dtype).type
    f0 = np.asarray(f0, dt)
    kappa_rel = np.asarray(kappa_rel, dt)
    alpha = np.asarray(alpha, dt)
    gamma = dt(2.0) * f0
    K = kappa_rel * gamma
    two_t = dt(2.0 * theta_t - 1.0)
    h_1 = dt(lambda_c) * np.sqrt(
        (gamma**2 * dt(k) ** 2
         + np.sqrt(gamma**4 * dt(k) ** 4
                   + dt(16.0) * K**2 * dt(k) ** 2 * two_t))
        / (dt(2.0) * two_t)
    )
    eps4 = dt(4.0) * np.finfo(dt).eps
    N_t = np.floor((dt(1.0) / h_1) * (dt(1.0) + eps4))
    h_t = dt(1.0) / N_t
    h_2 = dt(lambda_c) * gamma * alpha * dt(k)
    N_l = np.floor((dt(1.0) / h_2) * (dt(1.0) + eps4))
    h_l = dt(1.0) / N_l
    return DerivedVars(gamma, K, N_t, h_t, N_l, h_l)


def grid_widths_np(f0, kappa_rel, k, theta_t, lambda_c, dtype=np.float32):
    """Transverse interval count ``N_t`` for host-side consumers, with the
    same epsilon-guarded floor as :func:`get_derived_vars`."""
    dt = np.dtype(dtype).type
    f0 = np.asarray(f0, dt)
    gamma = dt(2.0) * f0
    K = dt(kappa_rel) * gamma
    two_t = dt(2.0 * theta_t - 1.0)
    h_1 = dt(lambda_c) * np.sqrt(
        (gamma**2 * dt(k) ** 2
         + np.sqrt(gamma**4 * dt(k) ** 4
                   + dt(16.0) * K**2 * dt(k) ** 2 * two_t))
        / (dt(2.0) * two_t)
    )
    eps4 = dt(4.0) * np.finfo(dt).eps
    return np.floor((dt(1.0) / h_1) * (dt(1.0) + eps4))


def get_theta(kappa_max, f0_inf, sr, lambda_c=1):
    """Theta-scheme free parameter (reference ``fdm.py:125-141``)."""
    gamma = 2.0 * f0_inf
    kappa = gamma * kappa_max
    k = 1.0 / sr
    if kappa == 0:
        return 0.5 + 2.0 / (math.pi**2)
    R = ((gamma**4 * k**2 + 4.0 * kappa**2 * math.pi**2) / (gamma**4 * k**2)) ** 0.5
    S = gamma**4 * k**2 * lambda_c**2 / (4.0 * kappa**2 * math.pi**4)
    theta = 0.5 + 2.0 * S * lambda_c**2 * (R - 1.0) ** 2 + math.pi**2 * S * (R - 1.0)
    if theta >= 1:
        raise ValueError(f"theta {theta} >= 1")
    return theta


def stiff_string_modes(f0, kappa_rel, p_max=1):
    """Fletcher inharmonic mode frequencies of a lossless stiff string.

    Returns ``(modes, factors)`` like reference ``fdm.py:143-158``:
    ``w_p = p (1 + (2/pi) sqrt(B) + (4/pi^2) B) sqrt(1 + B p^2)`` with
    ``B = (pi kappa_rel)^2``; ``modes[p] = f0 * w_p``.  Takes numpy arrays,
    torch tensors or scalars.
    """
    sqrt = torch.sqrt if isinstance(kappa_rel, torch.Tensor) else np.sqrt
    B = (np.pi * kappa_rel) ** 2
    modes, factor = [], []
    for p in range(1, p_max + 1):
        w_p = (
            p
            * (1.0 + (2.0 / np.pi) * sqrt(B) + (4.0 / np.pi**2) * B)
            * sqrt(1.0 + B * p**2)
        )
        factor.append(w_p)
        modes.append(f0 * w_p)
    return modes, factor


def t60_to_sigma(T60, gamma, K):
    """Two-point T60 spec -> (sigma0, sigma1) loss terms (reference
    ``string.cpp:96-120``).  ``T60`` is ``(B, 2, 2)`` with
    ``T60[:, i] = (freq_i, time_i)``; ``gamma``/``K`` are ``(B,)`` tensors.
    A zero anywhere in T60 selects the lossless branch (sigma = 0)."""
    freq1 = T60[:, 0, 0]
    freq2 = T60[:, 1, 0]
    time1 = T60[:, 0, 1]
    time2 = T60[:, 1, 1]

    stiff = K > 0
    g2 = torch.where(gamma != 0, gamma, torch.ones_like(gamma)) ** 2
    zeta1 = torch.where(
        stiff,
        -(gamma**2) + torch.sqrt(gamma**4 + 4.0 * K**2 * (2.0 * np.pi * freq1) ** 2),
        freq1**2 / g2,
    )
    zeta2 = torch.where(
        stiff,
        -(gamma**2) + torch.sqrt(gamma**4 + 4.0 * K**2 * (2.0 * np.pi * freq2) ** 2),
        freq2**2 / g2,
    )
    lossy = T60.prod(dim=2).prod(dim=1) != 0
    one = torch.ones_like(time1)
    safe_t1 = torch.where(time1 != 0, time1, one)
    safe_t2 = torch.where(time2 != 0, time2, one)
    lossy_f = lossy.to(zeta1.dtype)
    sig0 = torch.where(lossy, -zeta2 / safe_t1 + zeta1 / safe_t2, lossy_f)
    sig1 = torch.where(lossy, 1.0 / safe_t1 - 1.0 / safe_t2, lossy_f)
    scale = LN10_6 / (zeta1 - zeta2)
    return scale * sig0, scale * sig1


def initialize_state_rows(u0, v0, k):
    """First two time rows of the displacement field (reference
    ``fdm.py:77-99``): ``u1 = u0 + k v0`` (row n-1) and ``u2 = u0`` (row
    n-2).  Works on numpy arrays and torch tensors alike."""
    return u0 + k * v0, u0
