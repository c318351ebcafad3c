"""The port's fdm, stencil and tridiagonal ops against the JAX package's.

Same float64 inputs from a numpy seed go through both packages; results
agree to 1e-12 relative (the same arithmetic in the same order, up to
library-level rounding of sqrt/pow).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.ops import fdm as jfdm
from torch_fdtd_string_tpu.ops import stencils as jst
from torch_fdtd_string_tpu.ops import tridiag as jtd
from torch_fdtd_string_tpu_torch.ops import fdm as tfdm
from torch_fdtd_string_tpu_torch.ops import stencils as tst
from torch_fdtd_string_tpu_torch.ops import tridiag as ttd

RTOL = 1e-12
B, M = 5, 37
SR = 48000
K = 1.0 / SR
THETA = 0.575


def _rng():
    return np.random.default_rng(1234)


def T(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def J(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


def _close(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _string_inputs():
    g = _rng()
    f0 = g.uniform(98.0, 440.0, (B, 1))
    kappa = g.uniform(0.01, 0.03, (B, 1))
    alpha = g.uniform(1.0, 25.0, (B, 1))
    t60 = np.stack(
        [np.stack([g.uniform(1000, 6000, B), g.uniform(10, 25, B)], 1),
         np.stack([g.uniform(100, 900, B), g.uniform(10, 30, B)], 1)], 1)
    return f0, kappa, alpha, t60


def _fdm_derived():
    f0, kappa, alpha, _ = _string_inputs()
    want = jfdm.get_derived_vars(J(f0), J(kappa), K, THETA, 1.0, J(alpha))
    got = tfdm.get_derived_vars(T(f0), T(kappa), K, THETA, 1.0, T(alpha))
    for g, w in zip(got, want):
        _close(g, w)


def _fdm_derived_np():
    for f0 in (98.0, 220.0, 440.0):
        got = tfdm.get_derived_vars_np(f0, 0.02, K, THETA, 1.0, 3.0)
        want = jfdm.get_derived_vars_np(f0, 0.02, K, THETA, 1.0, 3.0)
        assert got == want


def _fdm_derived_host():
    f0, kappa, alpha, _ = _string_inputs()
    for dt in (np.float32, np.float64):
        got = tfdm.get_derived_vars_host(f0, kappa, K, THETA, 1.0, alpha, dtype=dt)
        want = jfdm.get_derived_vars_host(f0, kappa, K, THETA, 1.0, alpha, dtype=dt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _fdm_grid_widths():
    f0, _, _, _ = _string_inputs()
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(
            tfdm.grid_widths_np(f0, 0.02, K, THETA, 1.0, dtype=dt),
            jfdm.grid_widths_np(f0, 0.02, K, THETA, 1.0, dtype=dt))


def _fdm_theta():
    for kappa_max, f0_inf in ((0.03, 98.0), (0.08, 20.0), (0.0, 55.0)):
        assert tfdm.get_theta(kappa_max, f0_inf, SR) == jfdm.get_theta(
            kappa_max, f0_inf, SR)


def _fdm_modes():
    _, kappa, _, _ = _string_inputs()
    for p in (1, 4):
        g_modes, g_fac = tfdm.stiff_string_modes(2.0, kappa, p)
        w_modes, w_fac = jfdm.stiff_string_modes(2.0, kappa, p)
        for g, w in zip(g_modes + g_fac, w_modes + w_fac):
            _close(g, w)
        t_modes, _ = tfdm.stiff_string_modes(2.0, T(kappa), p)
        for g, w in zip(t_modes, w_modes):
            _close(g, w)


def _fdm_sigma():
    f0, kappa, _, t60 = _string_inputs()
    gamma = 2.0 * f0[:, 0]
    K_ = kappa[:, 0] * gamma
    t60_lossless = t60.copy()
    t60_lossless[0, 0, 1] = 0.0
    for T60 in (t60, t60_lossless):
        for K__ in (K_, np.zeros_like(K_)):
            got = tfdm.t60_to_sigma(T(T60), T(gamma), T(K__))
            want = jfdm.t60_to_sigma(J(T60), J(gamma), J(K__))
            for g, w in zip(got, want):
                _close(g, w)


def _fdm_init_rows():
    g = _rng()
    u0, v0 = g.standard_normal((B, M)), g.standard_normal((B, M))
    got = tfdm.initialize_state_rows(T(u0), T(v0), K)
    want = jfdm.initialize_state_rows(J(u0), J(v0), K)
    for a, b in zip(got, want):
        _close(a, b)


FDM_CASES = {
    "get_derived_vars": _fdm_derived,
    "get_derived_vars_np": _fdm_derived_np,
    "get_derived_vars_host": _fdm_derived_host,
    "grid_widths_np": _fdm_grid_widths,
    "get_theta": _fdm_theta,
    "stiff_string_modes": _fdm_modes,
    "t60_to_sigma": _fdm_sigma,
    "initialize_state_rows": _fdm_init_rows,
}


@pytest.mark.parametrize("case", sorted(FDM_CASES))
def test_fdm_matches_jax(case):
    FDM_CASES[case]()


def _stencil_args():
    g = _rng()
    x = g.standard_normal((B, M))
    h = g.uniform(0.005, 0.02, (B, 1))
    n = g.integers(M // 2, M, B).astype(np.float64)
    return x, h, n


STENCIL_CASES = {
    "shift+1": lambda x, h, n: (tst.shift(T(x), 1), jst.shift(J(x), 1)),
    "shift-2": lambda x, h, n: (tst.shift(T(x), -2), jst.shift(J(x), -2)),
    "shift_fill": lambda x, h, n: (tst.shift(T(x), 3, 1.5), jst.shift(J(x), 3, 1.5)),
    "dxx": lambda x, h, n: (tst.dxx(T(x), T(h)), jst.dxx(J(x), J(h))),
    "dxf": lambda x, h, n: (tst.dxf(T(x), T(h)), jst.dxf(J(x), J(h))),
    "dxb": lambda x, h, n: (tst.dxb(T(x), T(h)), jst.dxb(J(x), J(h))),
    "dxxxx": lambda x, h, n: (tst.dxxxx(T(x), T(h)), jst.dxxxx(J(x), J(h))),
    "dxxxx_clamped": lambda x, h, n: (tst.dxxxx_clamped(T(x), T(h), T(n)),
                                      jst.dxxxx_clamped(J(x), J(h), J(n))),
    "mxc": lambda x, h, n: (tst.mxc(T(x)), jst.mxc(J(x))),
    "theta_op": lambda x, h, n: (tst.theta_op(T(x), THETA),
                                 jst.theta_op(J(x), THETA)),
    "mask_live": lambda x, h, n: (tst.mask_live(T(x), T(n)),
                                  jst.mask_live(J(x), J(n))),
    "triangular": lambda x, h, n: (
        tst.triangular(M, T(n), T(np.linspace(0.0, 0.9, B)), T(np.full(B, 0.01))),
        jst.triangular(M, J(n), J(np.linspace(0.0, 0.9, B)), J(np.full(B, 0.01)))),
}


@pytest.mark.parametrize("case", sorted(STENCIL_CASES))
def test_stencils_match_jax(case):
    got, want = STENCIL_CASES[case](*_stencil_args())
    assert got.dtype == torch.float64
    _close(got, want)


def _tridiag_system(g):
    """Diagonally dominant masked system with per-element live sizes."""
    n = g.integers(M // 2, M + 1, B)
    idx = np.arange(M)[None, :]
    live = idx < n[:, None]
    a = g.uniform(-1.0, 1.0, (B, M))
    c = g.uniform(-1.0, 1.0, (B, M))
    sub = np.where((idx >= 1) & live, a, 0.0)
    sup = np.where(idx < n[:, None] - 1, c, 0.0)
    diag = np.where(live, 3.0 + g.uniform(0.0, 1.0, (B, M)), 1.0)
    rhs = np.where(live, g.standard_normal((B, M)), 0.0)
    return sub, diag, sup, rhs


def _td_solve():
    sub, diag, sup, rhs = _tridiag_system(_rng())
    _close(ttd.tridiag_solve(T(sub), T(diag), T(sup), T(rhs)),
           jtd.tridiag_solve(J(sub), J(diag), J(sup), J(rhs)))


def _td_matvec():
    sub, diag, sup, rhs = _tridiag_system(_rng())
    _close(ttd.tridiag_matvec(T(sub), T(diag), T(sup), T(rhs)),
           jtd.tridiag_matvec(J(sub), J(diag), J(sup), J(rhs)))


def _td_pcr_normalized():
    """The kernel's normalized PCR solves the same systems: its solution
    matches the JAX solve and satisfies T x = rhs."""
    sub, diag, sup, rhs = _tridiag_system(_rng())
    x = ttd.pcr_normalized(T(sub), T(diag), T(sup), T(rhs), levels=6)
    want = jtd.tridiag_solve(J(sub), J(diag), J(sup), J(rhs))
    _close(x, want)
    _close(ttd.tridiag_matvec(T(sub), T(diag), T(sup), x), rhs)


TRIDIAG_CASES = {
    "tridiag_solve": _td_solve,
    "tridiag_matvec": _td_matvec,
    "pcr_normalized": _td_pcr_normalized,
}


@pytest.mark.parametrize("case", sorted(TRIDIAG_CASES))
def test_tridiag_matches_jax(case):
    TRIDIAG_CASES[case]()
