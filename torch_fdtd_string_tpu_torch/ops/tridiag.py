"""Batched tridiagonal solves by parallel cyclic reduction (PCR), on torch.

PyTorch port of ``torch_fdtd_string_tpu/ops/tridiag.py``.  The LHS blocks of
the implicit scheme are tridiagonal, so no matrix is materialised: PCR solves
every batch element's system in ``ceil(log2(M))`` data-parallel levels of
shift-multiply-add.  Variable per-element sizes are handled by identity
padding: rows beyond an element's live size are ``(0, 1, 0 | rhs=0)``.
``toeplitz_tridiag_coeffs`` builds that layout for a Toeplitz system, and
``dst_toeplitz_solve`` solves one in closed form.

``partition_factor`` and ``partition_solve`` are the plain version of the
CUDA string kernel's solve (``csrc/string_step.cu``): each element's live
rows are cut into 32 contiguous blocks, one per lane of a warp, each block
eliminated locally down to its first and last row, and the 64-row reduced
system solved by six PCR levels.  The factorization depends on the matrix
only, so a step factors once and solves many right-hand sides.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LANES = 32  # blocks of the partitioned solve: the lanes of one warp
REDUCED_LEVELS = 6  # PCR levels of its 2 * LANES-row reduced system


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
    """PCR in normalized form, as the JAX package's fused string kernel
    runs it (``pallas_step.py:219-241``).

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


def live_rows(n, width):
    """Rows ``i`` in ``[0, width)`` with ``i < n``, per element: the count of
    live rows of a grid whose live size is the float ``n`` (NaN counts 0,
    a size past ``width`` counts ``width``).  ``n``: (B,) or (B, 1) float;
    returns (B,) int64."""
    n = n.reshape(-1)
    count = torch.clamp(torch.ceil(torch.nan_to_num(n, nan=0.0)), 0, width)
    return count.to(torch.int64)


def partition_blocks(n):
    """Each lane's block of rows, ``(start, size)``, both (B, LANES) int64,
    from the live row counts ``n`` (B,).  ``P = min(LANES, max(1, n // 2))``
    blocks of ``n // P`` rows, the first ``n % P`` one row longer, so that
    every block of a system of two rows or more has two rows or more; lanes
    from ``P`` on hold none.  The blocks depend on ``n`` alone, never on the
    width the rows are padded to."""
    n = n.reshape(-1, 1)
    lane = torch.arange(LANES, device=n.device)[None, :]
    P = torch.clamp(n // 2, 1, LANES)
    base, extra = n // P, n % P
    size = torch.where(lane < P, base + (lane < extra).to(n.dtype), 0)
    start = lane * base + torch.minimum(lane, extra)
    return torch.where(lane < P, start, n), size


class PartitionFactor(NamedTuple):
    """What :func:`partition_factor` keeps of a batch of matrices: the
    row index of every lane slot (B, LANES, R) and whether it is live; per
    slot the forward factors ``P``, ``Q``, the backward factor ``G`` and
    the back substitution's ``Aa``, ``Gg``; the block sizes; and per PCR
    level of the reduced system its ``(a, c, rD)``, each (B, 2 LANES)."""
    idx: torch.Tensor
    valid: torch.Tensor
    size: torch.Tensor
    P: torch.Tensor
    Q: torch.Tensor
    G: torch.Tensor
    Aa: torch.Tensor
    Gg: torch.Tensor
    levels: tuple


def _pair(first, last):
    """(B, LANES) first-row and last-row values as the reduced system's
    (B, 2 LANES) rows: lane j's first row at 2j, its last at 2j + 1."""
    return torch.stack((first, last), dim=-1).reshape(first.shape[0], 2 * LANES)


def partition_factor(sub, diag, sup, n):
    """Factor the tridiagonal systems ``(sub, diag, sup)`` (B, W) on their
    live rows ``[0, n)`` (``n`` (B,) int64, at most W) as the string kernel
    does, for :func:`partition_solve`.  Rows past ``n`` are identity rows,
    ``sub[n] = 0`` and ``sup[n - 1] = 0`` (or ``n == W``).

    Per block ``[s, e]`` of ``m`` rows (:func:`partition_blocks`), with
    rows scaled to unit diagonal (``a = sub / diag``, ``c = sup / diag``):
    the forward pass eliminates each row's lower neighbour from row ``s + 2``
    on, so row ``i`` reads ``alpha_i x_s + x_i + gamma_i x_{i+1}``; the
    backward pass from ``e - 1`` writes rows ``s + 1 .. e - 1`` in ``x_s``
    and ``x_e`` alone (``alpha'``, ``gamma'``) and row ``s`` in ``x_{s-1}``
    and ``x_e``.  Rows ``s`` and ``e`` of every block form the reduced
    system, tridiagonal in 2 LANES rows, whose PCR levels are factored
    here too.  No pivoting: like PCR, it relies on diagonal dominance."""
    B, W = diag.shape
    dt, dev = diag.dtype, diag.device
    start, size = partition_blocks(n)
    R = max(int(size.max()), 1)
    slot = torch.arange(R, device=dev)
    idx = torch.clamp(start[..., None] + slot, max=W - 1)
    valid = slot < size[..., None]
    take = lambda x, fill: torch.where(
        valid, torch.gather(x, 1, idx.reshape(B, -1)).reshape(B, LANES, R),
        torch.full((), fill, dtype=dt, device=dev))
    rb = 1.0 / take(diag, 1.0)
    a = take(sub, 0.0) * rb
    c = take(sup, 0.0) * rb
    zero = torch.zeros((B, LANES), dtype=dt, device=dev)
    P, Q = [rb[..., 0]], [zero]
    alpha, gamma = [zero], [zero]
    if R > 1:
        P.append(rb[..., 1])
        Q.append(zero)
        alpha.append(a[..., 1])
        gamma.append(c[..., 1])
    for j in range(2, R):  # forward: eliminate x_{i-1}
        r = 1.0 / (1.0 - a[..., j] * gamma[j - 1])
        alpha.append(-(a[..., j] * alpha[j - 1]) * r)
        gamma.append(c[..., j] * r)
        P.append(rb[..., j] * r)
        Q.append(a[..., j] * r)
    # backward: rows 1 .. m - 2 of a block in x_s and x_e; row m - 2 starts
    m = size
    Aa, Gg = list(alpha), list(gamma)
    for j in range(R - 3, 0, -1):
        inner = j < m - 2
        Aa[j] = torch.where(inner, alpha[j] - gamma[j] * Aa[j + 1], alpha[j])
        Gg[j] = torch.where(inner, -(gamma[j] * Gg[j + 1]), gamma[j])
    last = torch.clamp(m - 1, min=0)[..., None]
    pick = lambda xs: torch.gather(torch.stack(xs, dim=-1), 2, last)[..., 0]
    a0, c0, rb0 = a[..., 0], c[..., 0], rb[..., 0]
    if R > 2:
        rs = 1.0 / (1.0 - c0 * Aa[1])
        long = m >= 3
        P[0] = torch.where(long, rb0 * rs, rb0)
        Q[0] = torch.where(long, c0 * rs, zero)
        A_f = torch.where(long, a0 * rs, a0)
        C_f = torch.where(long, -(c0 * Gg[1]) * rs, c0)
    else:
        A_f, C_f = a0, c0
    A_l, C_l = pick(alpha), pick(gamma)
    one = m == 1  # a lone row: both reduced rows carry it, uncoupled
    C_f = torch.where(one, zero, C_f)
    A_l = torch.where(one, zero, A_l)
    C_l = torch.where(one, c0, C_l)
    empty = m == 0
    A_f, C_f, A_l, C_l = (torch.where(empty, zero, x) for x in (A_f, C_f, A_l, C_l))
    a, c = _pair(A_f, A_l), _pair(C_f, C_l)
    levels = []
    s = 1
    for _ in range(REDUCED_LEVELS):
        P2 = torch.nn.functional.pad(torch.stack((a, c)), (s, s))
        a_m, c_m = P2[..., : 2 * LANES].unbind(0)
        a_p, c_p = P2[..., 2 * s :].unbind(0)
        rD = 1.0 / (1.0 - a * c_m - c * a_p)
        levels.append((a, c, rD))
        a, c = -(a * a_m) * rD, -(c * c_p) * rD
        s *= 2
    st = lambda xs: torch.stack(xs, dim=-1)
    return PartitionFactor(idx, valid, size, st(P), st(Q), st(gamma), st(Aa), st(Gg),
                           tuple(levels))


def partition_solve(f, rhs):
    """Solve the systems that :func:`partition_factor` factored for the
    right-hand sides ``rhs`` (B, W), in the string kernel's order: per block
    the forward pass (``delta_i = rhs_i P_i - Q_i delta_{i-1}``), the
    backward pass (``delta'_i = delta_i - G_i delta'_{i+1}``), the reduced
    system's PCR levels (``d = (d - a d_m - c d_p) rD``), then every inner
    row from its block's first and last (``x_i = delta'_i - Aa_i x_s -
    Gg_i x_e``).  Rows past the live count come back as ``rhs``."""
    B, W = rhs.shape
    R = f.P.shape[-1]
    m = f.size
    g = torch.where(f.valid, torch.gather(rhs, 1, f.idx.reshape(B, -1)).reshape(f.idx.shape),
                    torch.zeros((), dtype=rhs.dtype, device=rhs.device))
    zero = torch.zeros_like(g[..., 0])
    d0 = g[..., 0] * f.P[..., 0]
    delta = [d0]
    if R > 1:
        delta.append(g[..., 1] * f.P[..., 1])
    for j in range(2, R):
        delta.append(g[..., j] * f.P[..., j] - f.Q[..., j] * delta[j - 1])
    dp = list(delta)
    for j in range(R - 3, 0, -1):
        dp[j] = torch.where(j < m - 2, delta[j] - f.G[..., j] * dp[j + 1], delta[j])
    last = torch.clamp(m - 1, min=0)[..., None]
    D_l = torch.where(m >= 2, torch.gather(torch.stack(delta, dim=-1), 2, last)[..., 0], d0)
    D_f = d0 - f.Q[..., 0] * dp[1] if R > 2 else d0
    D_f = torch.where(m >= 3, D_f, d0)
    d = _pair(D_f, D_l)
    d = torch.where(_pair(m, m) == 0, torch.zeros_like(d), d)
    s = 1
    for a, c, rD in f.levels:
        P2 = torch.nn.functional.pad(d, (s, s))
        d = (d - a * P2[..., : 2 * LANES] - c * P2[..., 2 * s :]) * rD
        s *= 2
    x_f, x_l = d.reshape(B, LANES, 2).unbind(-1)
    x = (torch.stack(dp, dim=-1) - f.Aa * x_f[..., None]) - f.Gg * x_l[..., None]
    slot = torch.arange(R, device=rhs.device)
    x = torch.where(slot == 0, x_f[..., None], x)
    x = torch.where((slot == (m - 1)[..., None]) & (m >= 2)[..., None], x_l[..., None], x)
    # live slots back into their rows; the dead ones into a spare column
    out = torch.nn.functional.pad(rhs, (0, 1))
    dest = torch.where(f.valid, f.idx, W)
    out.scatter_(1, dest.reshape(B, -1), x.reshape(B, -1))
    return out[:, :W]
