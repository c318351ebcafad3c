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


def dxf_diag_dxb(x, d, h):
    """Apply ``Dxf @ diag(d) @ Dxb`` as a stencil: row ``i`` is
    ``[d_i, -(d_i + d_{i+1}), d_{i+1}] / h^2`` on ``(x[i-1], x[i], x[i+1])``,
    with ``d_M`` (out of range) taken as zero."""
    d_next = shift(d, -1)
    return (d * shift(x, 1) - (d + d_next) * x + d_next * shift(x, -1)) / (h * h)


def mask_live(x, count, M=None):
    """Zero entries with index >= count (``count`` is ``(B,)``), as the
    reference's ``mask_1d(u, N, N_max)``.  Multiplies, so NaN stays NaN.
    ``M`` defaults to the last axis' length."""
    idx = torch.arange(M or x.shape[-1], dtype=x.dtype, device=x.device)
    return x * (idx[None, :] < count[:, None]).to(x.dtype)


def dirichlet(x, n):
    """Zero entries at index 0 and index ``n`` (``(B,)``) per batch element."""
    idx = torch.arange(x.shape[-1], device=x.device)
    keep = (idx[None, :] != 0) & (idx[None, :] != n[:, None])
    return x * keep.to(x.dtype)


def raised_cosine(n, ctr, wid, M):
    """Normalised raised-cosine spreading profile (``misc.cpp:20-34``).

    ``n`` is the ``(B,)`` active sample count in space (the reference passes
    ``N - 1``), ``ctr``/``wid`` the ``(B,)`` centre and width in (0, 1],
    ``M`` the static padded width.  Returns ``(B, M)``; a window that
    captures no grid point divides 0 by 0, and the caller ``nan_to_num``s
    the force as the reference does (``string.cpp:225``).
    """
    h = 1.0 / M
    # jnp.linspace(h, 1, M): start (1 - s) + stop s, the last point exact
    step = torch.arange(M - 1, dtype=ctr.dtype, device=ctr.device) / (M - 1)
    xax = torch.cat([h * (1 - step) + 1.0 * step,
                     torch.ones(1, dtype=ctr.dtype, device=ctr.device)])[None, :]
    c = (ctr * n / M)[:, None]
    w = (wid * n / M)[:, None]
    ind = torch.clamp(-(xax - c - w / 2.0) * (xax - c + w / 2.0), min=0.0)
    ind = torch.where(torch.isnan(ind), ind, torch.sign(ind))  # jnp.sign
    out = 0.5 * ind * (1.0 + torch.cos(2.0 * torch.pi * (xax - c) / w))
    return out / torch.sum(torch.abs(out), dim=-1, keepdim=True)


def floor_dirac_delta(n, ctr, M):
    """One-hot at ``floor(ctr * n)`` (``misc.cpp:36-43``).  Returns ``(B, M)``."""
    idx = torch.arange(M, dtype=ctr.dtype, device=ctr.device)
    return (idx[None, :] == torch.floor(ctr * n)[:, None]).to(ctr.dtype)


def domain_x(M, n):
    """Non-dimensional x in [-1/2, 1/2] (``misc.cpp:45-52``):
    ``(clip(2 i / n, 0, 2) - 1) / 2`` for ``i`` in 0..M-1, saturating at +1/2
    beyond the live region.  ``n`` is ``(B,)``."""
    i = torch.arange(M, dtype=n.dtype, device=n.device)[None, :]
    return (torch.clamp(2.0 * i / n[:, None], 0.0, 2.0) - 1.0) / 2.0


def interp_linear(x, n_in, n_out, M_out):
    """Per-element linear resample of the first ``n_in`` entries of ``x``
    (``(B, M_in)``) onto ``n_out`` points (align_corners), zero beyond
    ``n_out``; the reference's ``batched_interpolator(N_i, N_o)`` applied by
    gathers (``misc.cpp:78-105``).  Returns ``(B, M_out)``."""
    M_in = x.shape[-1]
    i = torch.arange(M_out, dtype=x.dtype, device=x.device)[None, :]
    denom = torch.clamp(n_out[:, None] - 1.0, min=1.0)
    pos = i * (n_in[:, None] - 1.0) / denom
    pos = torch.minimum(torch.clamp(pos, min=0.0), n_in[:, None] - 1.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = torch.clamp(lo.long(), 0, M_in - 1)
    hi_i = torch.clamp(lo_i + 1, 0, M_in - 1)
    out = torch.gather(x, -1, lo_i) * (1.0 - frac) + torch.gather(x, -1, hi_i) * frac
    return out * (i < n_out[:, None]).to(x.dtype)


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
