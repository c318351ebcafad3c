"""Batched tridiagonal solves by parallel cyclic reduction (PCR), on torch.

PyTorch port of ``torch_fdtd_string_tpu/ops/tridiag.py``.  The LHS blocks of
the implicit scheme are tridiagonal, so no matrix is materialised: PCR solves
every batch element's system in ``ceil(log2(M))`` data-parallel levels of
shift-multiply-add.  Variable per-element sizes are handled by identity
padding: rows beyond an element's live size are ``(0, 1, 0 | rhs=0)``.
``toeplitz_tridiag_coeffs`` builds that layout for a Toeplitz system, and
``dst_toeplitz_solve`` solves one in closed form.
"""

from __future__ import annotations

import math

import torch


def _shift(x, s, fill=0.0):
    """Shift last axis by ``s`` (s>0: toward higher indices), const fill."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype, device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., :-s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def tridiag_solve(sub, diag, sup, rhs):
    """Solve ``T x = rhs`` for batched tridiagonal ``T`` (textbook PCR).

    ``sub[i]`` couples row i to i-1 (``sub[0]`` must be 0), ``sup[i]`` row i
    to i+1 (``sup[M-1]`` must be 0), ``diag`` is nonzero (1 on padded rows).
    All arguments are ``(..., M)``; returns the ``(..., M)`` solution.
    """
    M = rhs.shape[-1]
    n_steps = max(1, math.ceil(math.log2(max(M, 2))))
    pad = torch.nn.functional.pad
    a, b, c, d = sub, diag, sup, rhs
    s = 1
    for _ in range(n_steps):
        # out-of-range neighbours behave as identity rows (b=1, a=c=d=0):
        # one padded copy of (a, c, d) and one of b give both neighbours
        P = pad(torch.stack((a, c, d)), (s, s))
        Pb = pad(b, (s, s), value=1.0)
        a_m, c_m, d_m = P[..., :M].unbind(0)
        a_p, c_p, d_p = P[..., 2 * s:].unbind(0)
        alpha = -a / Pb[..., :M]
        beta = -c / Pb[..., 2 * s:]
        a, b, c, d = (alpha * a_m, b + alpha * c_m + beta * a_p,
                      beta * c_p, d + alpha * d_m + beta * d_p)
        s *= 2
    return d / b


def pcr_normalized(sub, diag, sup, rhs, levels):
    """PCR in normalized form, as the fused string kernel runs it
    (``pallas_step.py:219-241``).

    Rows are first scaled to unit diagonal; each level then needs one
    reciprocal.  Padded rows are identity, so zero-filled shifts model
    out-of-range neighbours exactly.  ``levels`` must satisfy
    ``2**levels >= M``.
    """
    rb = 1.0 / diag
    a, c, d = sub * rb, sup * rb, rhs * rb
    M = rhs.shape[-1]
    s = 1
    for _ in range(levels):
        # one zero-padded copy gives the neighbours at -s and +s of a, c, d
        P = torch.nn.functional.pad(torch.stack((a, c, d)), (s, s))
        a_m, c_m, d_m = P[..., :M].unbind(0)
        a_p, c_p, d_p = P[..., 2 * s:].unbind(0)
        rD = 1.0 / (1.0 - a * c_m - c * a_p)
        a, c, d = (
            -(a * a_m) * rD,
            -(c * c_p) * rD,
            (d - a * d_m - c * d_p) * rD,
        )
        s *= 2
    return d


def dst_toeplitz_solve(a, b, c, n, rhs):
    """Closed-form solve of the Toeplitz tridiagonal ``tridiag(a, b, c)`` of
    live size ``n`` per element, in its sine eigenbasis (eigenvalues
    ``b + (a + c) cos(k pi / (n + 1))``, eigenvectors ``sin(jk pi / (n + 1))``):
    two batched products, exact where ``a == c``.  The reference ships it as
    ``tridiagonal_inverse`` (misc.cpp:228-252, fdm.py:9-21) but keeps it off
    the hot path, as the JAX package does; it serves spectral analysis and
    the tests.

    ``a``, ``b``, ``c``, ``n``: (B,); ``rhs``: (B, M), whose dtype the
    solve takes.  Rows at or past ``n`` come back 0."""
    B, M = rhs.shape
    dtype, device = rhs.dtype, rhs.device
    a, b, c, n = (torch.as_tensor(x, dtype=dtype, device=device) for x in (a, b, c, n))
    j = torch.arange(1, M + 1, dtype=dtype, device=device)
    nb = n[:, None]
    k = j[None, :]
    lam = b[:, None] + (a + c)[:, None] * torch.cos(k * math.pi / (nb + 1.0))
    live = k <= nb
    lam = torch.where(live, lam, torch.ones_like(lam))
    V = torch.sqrt(2.0 / (nb + 1.0))[..., None] * torch.sin(
        j[None, :, None] * j[None, None, :] * math.pi / (nb + 1.0)[..., None])
    V = V * live[:, :, None] * live[:, None, :]
    y = torch.einsum("bij,bj->bi", V, rhs * live) / lam
    return torch.einsum("bij,bj->bi", V, y) * live


def toeplitz_tridiag_coeffs(a, b, n, M, dtype=None):
    """``(sub, diag, sup)`` of width ``M`` for each element's ``n x n``
    symmetric Toeplitz tridiagonal ``tridiag(a, b, a)``, identity-padded
    past row ``n``: the layout of :func:`tridiag_solve`.  ``a``, ``b``,
    ``n``: (B,); ``dtype`` defaults to that of ``a`` and ``b``
    promoted."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dtype = dtype or torch.promote_types(a.dtype, b.dtype)
    device = a.device
    a, b = a.to(dtype), b.to(dtype)
    n = torch.as_tensor(n, device=device)[:, None]
    idx = torch.arange(M, dtype=dtype, device=device)[None, :]
    live = idx < n
    zero = torch.zeros((), dtype=dtype, device=device)
    sub = torch.where((idx >= 1) & live, a[:, None], zero)
    diag = torch.where(live, b[:, None], torch.ones((), dtype=dtype, device=device))
    sup = torch.where(idx < n - 1, a[:, None], zero)
    return sub, diag, sup


def tridiag_matvec(sub, diag, sup, x):
    """``A @ x`` for the masked tridiagonal layout of :func:`tridiag_solve`:
    ``(Ax)_i = sub_i x_{i-1} + diag_i x_i + sup_i x_{i+1}``."""
    return sub * _shift(x, 1) + diag * x + sup * _shift(x, -1)
