"""Modal solution of the clamped lossy stiff string (host numpy/scipy).

Port of the parts of ``torch_fdtd_string_tpu/core/analytic.py`` that the
fused dataset path and the verification runs use: the mode frequencies and
shapes that label each training item (reference
``src/model/analytic.py:143-388``), the manufactured solution the MMS
runs are held to, and the lossless non-stiff string's sine series and its
(u, z) pair (reference analytic.py:38-76), the analytic fields of the
figures.  The roots of
the transcendental mode equations are found on the host by
Levenberg-Marquardt, seeded from a kappa-interpolated root table; the
coefficient fit is a direct ``lstsq`` solve.

The root table is built once by a dense sweep at 257 kappa points and
cached on disk under ``build/cache/`` of this checkout (git-ignored), and
in the process.  ``FDTD_NO_ROOT_TABLE=1`` seeds every solve from the dense
sweep instead.
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time

import numpy as np
import scipy.optimize
import scipy.signal

MACHINE_EPS = 2.23e-16
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "cache")


def manufactured_solution(Nt, Nx, gamma, sig0, p_a, sr):
    """u(x, t) = p_a cos^2(pi x) cos(gamma t) exp(-sig0 t) on x in [-1/2,
    1/2], ``(Nt, Nx)`` at t = n / sr (reference analytic.py:21-27)."""
    x = np.linspace(-0.5, 0.5, Nx)
    t = np.arange(Nt)[:, None] / sr
    return p_a * np.cos(np.pi * x)[None, :] ** 2 * np.cos(gamma * t) * np.exp(-sig0 * t)


def lossless_nonstiff_string(u0, f0, Nt, Nx, sr, L=1.0):
    """The ideal string's sine-series (d'Alembert) solution (reference
    analytic.py:38-54): ``u0`` (Nx,) the initial displacement on x in
    [0, L], ``f0`` a scalar or (Nt,); returns (Nt, Nx)."""
    u0 = np.asarray(u0, np.float64).reshape(-1)
    x = np.linspace(0, L, Nx)
    t = np.arange(Nt)[:, None] / sr
    c = 2 * L * np.reshape(np.asarray(f0, np.float64), (-1, 1))  # (Nt|1, 1)
    n = np.arange(1, Nx + 1)[None, :]
    sin_nx = np.sin(n[:, :, None] * np.pi * x[None, None, :] / L)  # (1, modes, Nx)
    b = 2 / L * (u0[None, :] * np.sin(n.T * np.pi * x[None, :] / L)).mean(axis=1)
    cos_t = np.cos(n * np.pi * c * t / L)  # (Nt, modes)
    return (cos_t * b[None, :]) @ sin_nx[0]


def nonlinear_wave_solution(u0, z0, f0, alpha, Nt, Nx, sr, L=1.0):
    """The (u, z) pair of sine-series solutions at wave speeds c and
    alpha c (reference analytic.py:56-76)."""
    u = lossless_nonstiff_string(u0, f0, Nt, Nx, sr, L)
    z = lossless_nonstiff_string(z0, np.asarray(f0) * alpha, Nt, Nx, sr, L)
    return u, z


def t60_to_sigma_scalar(T60, gamma, K):
    """Frequency-independent loss sigma from a (2, 2) T60 spec
    (reference analytic.py:128-141)."""
    T60 = np.asarray(T60, np.float64)
    zeta1 = -(gamma**2) + np.sqrt(gamma**4 + 4 * K**2 * (2 * np.pi * T60[0, 0]) ** 2)
    zeta2 = -(gamma**2) + np.sqrt(gamma**4 + 4 * K**2 * (2 * np.pi * T60[1, 0]) ** 2)
    sig0 = -zeta2 / T60[0, 1] + zeta1 / T60[1, 1]
    return 6 * math.log(10) * sig0 / (zeta1 - zeta2)


class StiffStringModes:
    """Mode frequencies/shapes of the clamped stiff string on [-L/2, L/2].

    Solves the even/odd transcendental equations (analytic.py:154-171):

      even:  mu1 tan(mu1 L/2) + mu2 tanh(mu2 L/2) = 0
      odd:   mu2 tan(mu1 L/2) - mu1 tanh(mu2 L/2) = 0

    with ``mu2 = sqrt(mu1^2 + 2 l)``, ``l = gamma^2 / (2 K^2)``, by a dense
    sweep (or the root table) for initial guesses followed by LM refinement.
    """

    def __init__(self, ell, L=1.0, s_min=math.pi / 2, s_max=100 * math.pi,
                 s_res=int(1e6)):
        self.l = float(ell)
        self.L = L
        self.s_min = s_min
        self.s_max = s_max
        self.s_res = s_res

    def _mu1(self, mu2):
        return np.sqrt(np.maximum(mu2**2 - 2 * self.l, 0.0))

    def _mu2(self, mu1):
        return np.sqrt(mu1**2 + 2 * self.l)

    def _f(self, mu2, kind):
        mu1 = self._mu1(mu2)
        h = self.L / 2
        if kind == "even":
            return mu1 * np.tan(mu1 * h) + mu2 * np.tanh(mu2 * h)
        return mu2 * np.tan(mu1 * h) - mu1 * np.tanh(mu2 * h)

    def sweep(self, kind, peak_val=1.0):
        mu1 = np.linspace(self.s_min, self.s_max, self.s_res)
        mu2 = self._mu2(mu1)
        val = np.abs(self._f(mu2, kind)).clip(max=peak_val)
        peaks = scipy.signal.find_peaks(
            peak_val - val, height=0.1 * peak_val, distance=math.pi / 2
        )[0]
        return np.sort(mu2[peaks])

    def refine(self, mu2_init, kind, strict=True):
        result = scipy.optimize.least_squares(
            lambda m2: self._f(m2, kind),
            mu2_init,
            method="lm",
            ftol=MACHINE_EPS,
            xtol=MACHINE_EPS,
            gtol=MACHINE_EPS,
        )
        if strict and not float(result.cost) < 1e-20:
            raise ArithmeticError(f"mode roots did not converge: cost {result.cost}")
        return np.sort(result.x)

    def roots(self, kind, strict=True, kappa_rel=None):
        """All family roots (refined mu2) in the sweep range.

        With ``kappa_rel`` inside the root table's range, the LM refinement
        is seeded from the table instead of the 1e6-point sweep; the refined
        roots agree with the sweep-seeded ones to ~1e-12 relative, and the
        root count per family is constant over the table's range.
        """
        if (kappa_rel is not None
                and os.environ.get("FDTD_NO_ROOT_TABLE") != "1"
                and self.L == 1.0 and self.s_min == math.pi / 2
                and self.s_max == 100 * math.pi
                and _ROOT_TABLE_LO <= kappa_rel <= _ROOT_TABLE_HI):
            kgrid, fams = root_tables()
            u = (kappa_rel - kgrid[0]) / (kgrid[1] - kgrid[0])
            i0 = min(int(u), len(kgrid) - 2)
            w = u - i0
            mu1_seed = fams[kind][i0] * (1.0 - w) + fams[kind][i0 + 1] * w
            out = self.refine(self._mu2(mu1_seed), kind, strict=strict)
            mu1 = self._mu1(out)
            # every refined root must stay in the sweep window and keep the
            # table's ordering margin, else seed from the sweep
            if (np.all(np.diff(out) > 0.1)
                    and mu1[0] >= self.s_min and mu1[-1] <= self.s_max):
                return out
        return self.refine(self.sweep(kind), kind, strict=strict)

    def shapes(self, mu2, kind, x):
        """Unit-coefficient mode shapes on grid ``x``: (n_modes, Nx)."""
        h = self.L / 2
        mu1 = self._mu1(mu2)
        if kind == "even":
            trig = np.cos(mu1[:, None] * x[None, :])
            corr = -np.cos(mu1 * h) / np.cosh(mu2 * h)
            hyp = corr[:, None] * np.cosh(mu2[:, None] * x[None, :])
        else:
            trig = np.sin(mu1[:, None] * x[None, :])
            corr = -np.sin(mu1 * h) / np.sinh(mu2 * h)
            hyp = corr[:, None] * np.sinh(mu2[:, None] * x[None, :])
        return trig + hyp


# root-table range: brackets every config's kappa draw range (nsynth-like:
# [0.01, 0.03]); outside it the dense sweep seeds the solve
_ROOT_TABLE_LO = 0.008
_ROOT_TABLE_HI = 0.04
_TABLE_LOCK = threading.Lock()
table_build_seconds = {}  # n_k -> wall seconds of the sweep build, when one ran


def root_tables(n_k=257):
    """``(kgrid, {"even": (n_k, 50), "odds": (n_k, 49)})`` mu1 root tables.

    Built once with the dense sweep + LM refinement at every kappa grid
    point, then read from ``CACHE_DIR``.  The root count per family must be
    the same at every grid point (checked as the table is built): that is
    what makes a table-seeded solve return the root set the sweep finds.
    """
    with _TABLE_LOCK:  # writer threads ask at once; build it once
        return _root_tables_cached(n_k)


@functools.lru_cache(maxsize=2)
def _root_tables_cached(n_k):
    path = os.path.join(
        CACHE_DIR,
        f"analytic_roots_{_ROOT_TABLE_LO:.6g}_{_ROOT_TABLE_HI:.6g}_{n_k}.npz",
    )
    if os.path.exists(path):
        z = np.load(path)
        return z["kgrid"], {"even": z["even"], "odds": z["odds"]}
    t0 = time.perf_counter()
    kgrid = np.linspace(_ROOT_TABLE_LO, _ROOT_TABLE_HI, n_k)
    fams = {"even": [], "odds": []}
    for kap in kgrid:
        solver = StiffStringModes(1.0 / (2.0 * kap * kap))
        for kind in ("even", "odds"):
            mu1 = solver._mu1(solver.refine(solver.sweep(kind), kind, strict=False))
            if fams[kind] and len(mu1) != len(fams[kind][0]):
                raise ArithmeticError(
                    f"root count changed across the table range at kappa "
                    f"{kap} ({kind}: {len(mu1)} vs {len(fams[kind][0])})")
            fams[kind].append(mu1)
    even = np.asarray(fams["even"])
    odds = np.asarray(fams["odds"])
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, kgrid=kgrid, even=even, odds=odds)
    os.replace(tmp, path)  # atomic: a concurrent process never reads a torn file
    table_build_seconds[n_k] = time.perf_counter() - t0
    return kgrid, {"even": even, "odds": odds}


def lossy_stiff_string(u0, f0, kappa_rel, t60, Nt, Nx, sr, L=1.0, strict=True,
                       return_field=True):
    """Full modal solution of the clamped lossy stiff string.

    Args mirror reference ``analytic.py:340-368``:
      u0: (1, Nx) or (Nx,) initial displacement on x in [-L/2, L/2].
      f0: scalar or (Nt,) fundamental (only f0[0] defines the mode problem).
      kappa_rel, t60 ((2,2)): string parameters.
    Returns (u (Nt, Nx), mode_freq (n_modes,) [rad/sample], mode_amps
    (n_modes, Nx)); ``return_field=False`` returns None for ``u``.
    """
    u0 = np.asarray(u0, np.float64).reshape(-1)
    f0_arr = np.reshape(np.asarray(f0, np.float64), (-1,))
    gamma = 2 * L * f0_arr[0]
    K = kappa_rel * gamma
    if not K > 0:
        raise ValueError(f"the modal solution needs a stiff string, kappa {kappa_rel}")
    ell = gamma**2 / (2 * K**2)
    sigma = t60_to_sigma_scalar(t60, gamma, K)

    x = np.linspace(-L / 2, L / 2, Nx)
    t = np.arange(Nt)[:, None] / sr

    solver = StiffStringModes(ell, L)
    freqs, amps = [], []
    u = np.zeros((Nt, Nx)) if return_field else None
    for kind in ("even", "odds"):
        mu2 = solver.roots(kind, strict=strict,
                           kappa_rel=float(kappa_rel) if L == 1.0 else None)
        mu1 = solver._mu1(mu2)
        X = solver.shapes(mu2, kind, x)  # (n, Nx) unit shapes
        # linear coefficient fit: sum_n b_n X_n = u0
        b, *_ = np.linalg.lstsq(X.T, u0, rcond=None)
        Xb = b[:, None] * X  # (n, Nx) fitted shapes
        varsg = mu1**4 * K**2 + mu1**2 * gamma**2
        omega = np.sqrt(np.maximum(varsg - sigma**2, 0.0))  # rad/s
        if return_field:
            T = np.exp(-sigma * t) * np.cos(omega[None, :] * t)  # (Nt, n)
            u += T @ Xb
        freqs.append(omega / sr)  # rad/sample
        amps.append(Xb)

    freqs = np.concatenate(freqs)
    amps = np.concatenate(amps, axis=0)
    order = np.argsort(freqs)
    return u, freqs[order], amps[order]
