"""Physics mode estimator: embedded dispersion tables and a batched
amplitude fit.

Port of ``torch_fdtd_string_tpu/models/physmodes.py``.  The DMSP mode labels
are an exact analytic computation from inputs the mode estimator already
receives (``core/analytic.lossy_stiff_string`` maps the u0 profile, kappa,
gamma and T60 to mode frequencies and per-x amplitudes), so this estimator
computes them instead of learning them:

* the clamped stiff string's root families depend only on kappa
  (``ell = 1 / (2 kappa^2)``), so a 1-D table ``mu1_n(kappa)`` per even/odd
  family, host-built once with the analytic solver's LM refinement,
  carries the whole root structure; linear interpolation on a 257-point
  grid is exact to ~2e-5 relative;
* mode frequencies are explicit given the roots:
  ``omega_n = sqrt(mu1^4 K^2 + mu1^2 gamma^2 - sigma^2)``;
* mode shapes are closed-form trig + hyperbolic terms, the hyperbolic
  ratio evaluated as ``exp(mu2 (|x| - L/2))`` so that nothing overflows
  float32;
* the amplitude fit is the host solver's per-family least squares, as two
  batched (n, n) normal-equation solves against the u0 profile upsampled
  to the solver grid by a constant spline operator.

No learned parameters.
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time

import numpy as np
import torch
from torch import nn

from ..core import analytic
from ..core.analytic import StiffStringModes
from ..utils import data as udata

L_HALF = 0.5  # string on x in [-1/2, 1/2] (analytic.py grid convention)
_TABLE_LOCK = threading.Lock()
table_build_seconds = {}  # table file name -> wall seconds of its build, when one ran


def mu1_tables(kappa_lo, kappa_hi, n_per_fam=28, n_k=257):
    """(kgrid (n_k,), even (n_k, n), odds (n_k, n)) MU1 root tables.

    mu1 (the trigonometric wavenumber) is tabulated, not mu2: for the low
    modes ``mu2 ~ sqrt(2 ell)``, so recovering mu1 from an interpolated mu2
    cancels catastrophically; ``mu2 = sqrt(mu1^2 + 2 ell)`` is the stable
    direction.  Host-built once with the sweep + LM refinement of
    ``core/analytic.StiffStringModes`` (~20 s for the default grid), cached
    under ``analytic.CACHE_DIR`` and in-process.  The grid spans
    [0.95 * kappa_lo, 1.05 * kappa_hi], so that config-range draws never
    clamp.
    """
    with _TABLE_LOCK:
        return _mu1_tables_cached(float(kappa_lo), float(kappa_hi), n_per_fam, n_k)


@functools.lru_cache(maxsize=4)
def _mu1_tables_cached(kappa_lo, kappa_hi, n_per_fam, n_k):
    lo, hi = 0.95 * kappa_lo, 1.05 * kappa_hi
    name = f"mu1tab_{lo:.6g}_{hi:.6g}_{n_per_fam}_{n_k}.npz"
    path = os.path.join(analytic.CACHE_DIR, name)
    if os.path.exists(path):
        z = np.load(path)
        return z["kgrid"], z["even"], z["odds"]
    t0 = time.perf_counter()
    kgrid = np.linspace(lo, hi, n_k)
    tabs = {"even": [], "odds": []}
    for kap in kgrid:
        solver = StiffStringModes(1.0 / (2.0 * kap * kap))
        for kind in ("even", "odds"):
            mu2 = solver.refine(solver.sweep(kind)[:n_per_fam], kind, strict=False)
            if len(mu2) < n_per_fam:
                raise ArithmeticError(f"{len(mu2)} {kind} roots at kappa {kap}, "
                                      f"not {n_per_fam}")
            tabs[kind].append(solver._mu1(mu2[:n_per_fam]))
    even, odds = np.asarray(tabs["even"]), np.asarray(tabs["odds"])
    os.makedirs(analytic.CACHE_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, kgrid=kgrid, even=even, odds=odds)
    os.replace(tmp, path)  # atomic: a concurrent process never reads a torn file
    table_build_seconds[name] = time.perf_counter() - t0
    return kgrid, even, odds


def _shapes(mu1, mu2, x, kind):
    """Mode shapes on grid x in [-1/2, 1/2]: (..., n, Nx).

    Twin of ``StiffStringModes.shapes`` with the hyperbolic ratio in
    overflow-safe exp form:  cosh(mu2 x)/cosh(mu2 h) =
    exp(mu2 (|x| - h)) (1 + e^{-2 mu2 |x|}) / (1 + e^{-2 mu2 h}).
    mu1/mu2: (..., n, 1); x broadcastable against them.
    """
    h = L_HALF
    ax = torch.abs(x)
    decay = torch.exp(mu2 * (ax - h))
    if kind == "even":
        trig = torch.cos(mu1 * x)
        ratio = decay * (1.0 + torch.exp(-2.0 * mu2 * ax)) / (1.0 + torch.exp(-2.0 * mu2 * h))
        hyp = -torch.cos(mu1 * h) * ratio
    else:
        trig = torch.sin(mu1 * x)
        ratio = torch.sign(x) * decay * (1.0 - torch.exp(-2.0 * mu2 * ax)) / (
            1.0 - torch.exp(-2.0 * mu2 * h))
        hyp = -torch.sin(mu1 * h) * ratio
    return trig + hyp


def _sigma_scalar(t60, gamma, K):
    """Twin of ``analytic.t60_to_sigma_scalar``; t60 (b, 2, 2),
    gamma/K (b, 1, 1) -> (b, 1, 1)."""
    f1, tm1 = t60[:, None, 0:1, 0], t60[:, None, 0:1, 1]
    f2, tm2 = t60[:, None, 1:2, 0], t60[:, None, 1:2, 1]
    g2 = gamma * gamma
    zeta1 = -g2 + torch.sqrt(g2 * g2 + 4.0 * K * K * (2 * math.pi * f1) ** 2)
    zeta2 = -g2 + torch.sqrt(g2 * g2 + 4.0 * K * K * (2 * math.pi * f2) ** 2)
    sig0 = -zeta2 / tm1 + zeta1 / tm2
    return 6.0 * math.log(10.0) * sig0 / (zeta1 - zeta2)


class PhysicsModeEstimator(nn.Module):
    """Drop-in ModeEstimator with the dispersion physics embedded.

    Same call signature/outputs as ``blocks.ModeEstimator`` plus the t60
    spec (the loss shift is part of the exact mode frequency): returns
    (mode_amps (b, 1, n_modes), mode_freq (b, 1, n_modes) [rad/sample]).
    The root tables are built (or read) when the module is.
    """

    def __init__(self, n_modes, kappa_scale, sr=48000, n_per_fam=28, na=1024,
                 ridge=1e-7):
        super().__init__()
        # families alternate in frequency, so the n_modes lowest merged
        # modes draw at most ~n_modes/2 + 2 from either family
        if n_per_fam < n_modes // 2 + 4:
            raise ValueError(f"n_per_fam {n_per_fam} too small for {n_modes} modes")
        self.n_modes, self.sr, self.na, self.ridge = n_modes, sr, na, ridge
        kgrid, tab_e, tab_o = mu1_tables(min(kappa_scale), max(kappa_scale), n_per_fam)
        self.k0, self.dk = float(kgrid[0]), float(kgrid[1] - kgrid[0])
        self.nk = kgrid.shape[0]
        self.register_buffer("tab", torch.as_tensor(np.stack([tab_e, tab_o]),
                                                    dtype=torch.float32), persistent=False)
        self._ops = {}

    def _upsample_op(self, n_in, like):
        """Constant (na, n_in) spline operator, the modal_target_host twin
        (u0 on the training grid -> the Na-point solver grid)."""
        key = (n_in, like.device, like.dtype)
        if key not in self._ops:
            self._ops[key] = torch.as_tensor(udata.spline_matrix(n_in, self.na, k=5),
                                             dtype=like.dtype, device=like.device)
        return self._ops[key]

    def forward(self, u_0, x_p, kappa, gamma, t60):
        """u_0: (b, 1, Nx) profile on the training grid; x_p/kappa/gamma:
        (b, 1, 1); t60: (b, 2, 2)."""
        tab = self.tab.to(u_0.dtype)
        b = u_0.shape[0]
        kap = kappa[:, 0, 0]  # (b,)
        # jnp.clip's gradient at the ends: maximum, then minimum
        u = torch.minimum(torch.maximum((kap - self.k0) / self.dk, kap.new_tensor(0.0)),
                          kap.new_tensor(self.nk - 1.000001))
        i0 = torch.floor(u).long()
        w = (u - i0)[None, :, None]  # (1, b, 1)
        mu1 = tab[:, i0] * (1.0 - w) + tab[:, i0 + 1] * w  # (2, b, n)
        mu1 = mu1.permute(1, 0, 2)[..., None]  # (b, 2, n, 1)
        ell = 1.0 / (2.0 * kap * kap)  # (b,)
        mu2 = torch.sqrt(mu1 * mu1 + 2.0 * ell[:, None, None, None])

        # frequencies: omega = sqrt(mu1^4 K^2 + mu1^2 gamma^2 - sigma^2)
        gam = gamma[:, :, :, None]  # (b, 1, 1, 1)
        K = kappa[:, :, :, None] * gam
        sig = _sigma_scalar(t60, gamma, kappa * gamma)[..., None]
        m2 = mu1 * mu1
        om = torch.sqrt(torch.maximum(m2 * m2 * K * K + m2 * gam * gam - sig * sig,
                                      m2.new_tensor(0.0)))[..., 0]
        om = om / self.sr  # (b, 2, n) rad/sample

        # amplitude fit: per-family least squares on the Na solver grid
        # (modal_target_host fits each family independently against u0)
        u0a = u_0[:, 0] @ self._upsample_op(u_0.shape[-1], u_0).T  # (b, Na)
        xs = torch.linspace(-L_HALF, L_HALF, self.na, dtype=u_0.dtype, device=u_0.device)
        coef = []
        for f, kind in enumerate(("even", "odds")):
            X = _shapes(mu1[:, f], mu2[:, f], xs[None, None], kind)  # (b, n, Na)
            G = X @ X.transpose(1, 2)
            n = X.shape[1]
            trace = G.diagonal(dim1=-2, dim2=-1).sum(-1)
            G = G + self.ridge * trace[:, None, None] / n * torch.eye(
                n, dtype=G.dtype, device=G.device)
            rhs = (X @ u0a[..., None])  # (b, n, 1)
            coef.append(torch.linalg.solve(G, rhs)[..., 0])  # (b, n)

        # shapes at the query pickup (training-grid x in [0, 1])
        xq = (x_p[..., 0] - L_HALF)[:, None]  # (b, 1, 1)
        amp = torch.stack([
            coef[f] * _shapes(mu1[:, f], mu2[:, f], xq, kind)[..., 0]
            for f, kind in enumerate(("even", "odds"))], dim=1)  # (b, 2, n)

        # merge families ascending in frequency, keep the n_modes lowest
        om_all = om.reshape(b, -1)
        amp_all = amp.reshape(b, -1)
        order = torch.argsort(om_all, dim=-1, stable=True)[:, : self.n_modes]
        mode_freq = torch.gather(om_all, -1, order)[:, None]
        mode_amps = torch.gather(amp_all, -1, order)[:, None]
        return mode_amps.to(u_0.dtype), mode_freq.to(u_0.dtype)
