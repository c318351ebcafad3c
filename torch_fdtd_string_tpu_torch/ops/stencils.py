"""Matrix-free spatial operators for the string FDTD scheme, on torch tensors.

PyTorch port of ``torch_fdtd_string_tpu/ops/stencils.py``.  Each difference
operator of the reference (``misc.cpp:119-166``) is applied as a shifted-add
stencil on ``(B, M)`` state vectors; zero-fill shifts reproduce the
finite-matrix truncation of the reference operators exactly.

Grid conventions (cf. ``string.cpp:137-148``): state vectors have a static
padded width ``M``; per batch element points ``0..n`` are live, and masks
implement the per-element live region.
"""

from __future__ import annotations

import torch


def shift(x, s, fill=0.0):
    """Shift along the last axis; ``s > 0`` moves values to higher indices."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype, device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., :-s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def dxx(x, h):
    """Second difference: ``(x[i+1] - 2 x[i] + x[i-1]) / h^2``."""
    return (shift(x, -1) - 2.0 * x + shift(x, 1)) / (h * h)


def dxf(x, h):
    """Forward difference: ``(x[i+1] - x[i]) / h``."""
    return (shift(x, -1) - x) / h


def dxb(x, h):
    """Backward difference: ``(x[i] - x[i-1]) / h``."""
    return (x - shift(x, 1)) / h


def dxxxx(x, h):
    """Fourth difference (simply-supported penta stencil)."""
    return (
        shift(x, -2) - 4.0 * shift(x, -1) + 6.0 * x - 4.0 * shift(x, 1) + shift(x, 2)
    ) / (h**4)


def dxxxx_clamped(x, h, n):
    """Fourth difference with the ``u_{-1} == u_1`` boundary correction
    (reference ``misc.cpp:146-163``): the penta stencil plus ``+1`` on the
    diagonal at rows ``1`` and ``n-2`` (``n`` = live point count, ``(B,)``)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    corr = (idx[None, :] == 1) | (idx[None, :] == (n[:, None] - 2))
    return dxxxx(x, h) + torch.where(corr, x, torch.zeros_like(x)) / (h**4)


def mxc(x):
    """Averaging operator ``(x[i+1] + x[i-1]) / 2`` (``misc.cpp:164-166``)."""
    return 0.5 * (shift(x, -1) + shift(x, 1))


def theta_op(x, theta):
    """Theta-weighted mass operator ``theta I + (1-theta) Mxc``."""
    return theta * x + (1.0 - theta) * mxc(x)


def mask_live(x, count):
    """Zero entries with index >= count (``count`` is ``(B,)``), as the
    reference's ``mask_1d(u, N, N_max)``.  Multiplies, so NaN stays NaN."""
    idx = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return x * (idx[None, :] < count[:, None]).to(x.dtype)


def triangular(M, n, p_x, p_a):
    """Batched triangular pluck profile (``misc.cpp:54-69``).

    ``M`` is the static padded point count, ``n`` the ``(B,)`` live point
    count, ``p_x``/``p_a`` the ``(B,)`` peak position and amplitude.
    Returns ``(B, M)``.
    """
    i = torch.arange(M, dtype=p_x.dtype, device=p_x.device)[None, :]
    zero = p_x <= 0
    one = torch.ones_like(p_x)
    nil = torch.zeros_like(p_x)
    vel_l = torch.where(zero, nil, p_a / torch.where(zero, one, p_x) / n)[:, None]
    vel_r = torch.where(zero, nil, p_a / torch.where(zero, one, 1.0 - p_x) / n)[:, None]
    left = torch.clamp(vel_l * i, min=0.0)
    right = torch.clamp(vel_r * (n[:, None] - 1.0 - i), min=0.0)
    return torch.minimum(left, right)
