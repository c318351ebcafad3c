"""Batched tridiagonal solves by parallel cyclic reduction (PCR), on torch.

PyTorch port of ``torch_fdtd_string_tpu/ops/tridiag.py``.  The LHS blocks of
the implicit scheme are tridiagonal, so no matrix is materialised: PCR solves
every batch element's system in ``ceil(log2(M))`` data-parallel levels of
shift-multiply-add.  Variable per-element sizes are handled by identity
padding: rows beyond an element's live size are ``(0, 1, 0 | rhs=0)``.
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


def tridiag_matvec(sub, diag, sup, x):
    """``A @ x`` for the masked tridiagonal layout of :func:`tridiag_solve`:
    ``(Ax)_i = sub_i x_{i-1} + diag_i x_i + sup_i x_{i+1}``."""
    return sub * _shift(x, 1) + diag * x + sup * _shift(x, -1)
