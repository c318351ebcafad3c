"""The port's scan engine (``core/engine.py``) against the JAX engine.

Float64, the bench workload (B=4): the same draws go through both
``simulate_chunk``s, every coupled solve (damped Gauss-Seidel, the fixed
sweep count, the rescue's GMRES), MMS forcing, and the bow, hammer and
mixed excitations with the Picard loop iterated to convergence
(``relative_error=12``).  Then the physics checks of tests/test_engine.py
on the port, at lengths cut for eager PyTorch.
"""

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.core import engine as jeng
from torch_fdtd_string_tpu_torch.core import engine as teng
from torch_fdtd_string_tpu_torch.ops import fdm
from torch_fdtd_string_tpu_torch.ops import stencils as st

SR = 48000
K_STEP = 1.0 / SR
FIELDS = ("uout", "zout", "u", "z", "v_r", "F_H", "u_H", "sig0", "sig1")


@pytest.fixture(scope="module")
def workload():
    import jax
    import jax.numpy as jnp

    args, B, _, _ = bench.build_workload(B=4, length=0.02, seed=7)
    carry, steps, sp, bp, hp, bm, hm, consts = args
    f64 = lambda t: jax.tree.map(
        lambda v: jnp.asarray(v, jnp.float64) if jnp.issubdtype(v.dtype, jnp.floating)
        else v, t)
    carry, sp, bp, hp = f64((carry, sp, bp, hp))
    return carry, steps, sp, bp, hp, consts


def _torch(tree, cls):
    return cls(*(torch.tensor(np.asarray(v)) for v in tree))


def _run_both(workload, T, bm, hm, bow_driven=False, **changes):
    import jax.numpy as jnp

    carry, steps, sp, bp, hp, consts = workload
    if bow_driven:  # a bow that moves and presses
        bp = bp._replace(v_b=jnp.full_like(bp.v_b, 0.2), F_b=jnp.full_like(bp.F_b, 50.0))
    c = consts._replace(collect_state=True, has_bow=bool(bm.any()),
                        has_hammer=bool(hm.any()), **changes)
    _, want = jeng.simulate_chunk(carry, steps[:T], sp, bp, hp, jnp.asarray(bm),
                                  jnp.asarray(hm), c)
    _, got = teng.simulate_chunk(
        _torch(carry, teng.Carry), np.asarray(steps[:T]), _torch(sp, teng.StringParams),
        _torch(bp, teng.BowParams), _torch(hp, teng.HammerParams),
        torch.tensor(bm), torch.tensor(hm), teng.SimConsts(*c))
    return {k: np.asarray(want[k]) for k in FIELDS}, {k: got[k].numpy() for k in FIELDS}


NONE = np.zeros(4, bool)
CASES = {
    "gs": (200, NONE, NONE, {}),
    "gmres": (64, NONE, NONE, dict(coupling_solver="gmres", coupling_max_iter=64)),
    "coupling_fixed_iters": (200, NONE, NONE, dict(coupling_fixed_iters=2)),
    "manufactured": (100, NONE, NONE, dict(manufactured=True)),
    "bow": (40, np.ones(4, bool), NONE, dict(relative_error=12.0)),
    "hammer": (24, NONE, np.ones(4, bool), dict(relative_error=12.0)),
    "mix": (24, np.array([1, 0, 1, 0], bool), np.array([0, 1, 0, 0], bool),
            dict(relative_error=12.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_chunk_matches_jax_engine(workload, case):
    """Every output within 1e-9 of its own scale (readings 1e-14 to 3e-12
    on a CPU)."""
    T, bm, hm, changes = CASES[case]
    want, got = _run_both(workload, T, bm, hm, bow_driven=bm.any(), **changes)
    for key in FIELDS:
        scale = np.abs(want[key]).max()
        assert np.isfinite(got[key]).all(), key
        assert np.abs(got[key] - want[key]).max() <= 1e-9 * scale, (key, scale)


def _mk(B, Nt, f0v, kappa, alpha, t60, p_a, pos, M_t, M_l, u0, uH1=-1e-3, **bow):
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    sp = teng.StringParams(kappa=t(np.full(B, kappa)), alpha=t(np.full(B, alpha)),
                           p_a=t(np.full(B, p_a)), f0=t(np.full((B, Nt), f0v)),
                           pos=t(np.full(B, pos)),
                           T60=t(np.tile([[[1000.0, t60], [100.0, t60]]], (B, 1, 1))))
    bp = teng.BowParams(x_b=t(np.full((B, Nt), bow.get("x_b", 0.2))),
                        v_b=t(bow.get("v_b", np.zeros((B, Nt)))),
                        F_b=t(np.full((B, Nt), bow.get("F_b", 0.0))),
                        phi_0=t(np.full(B, 9.0)), phi_1=t(np.full(B, 0.01)),
                        wid=t(np.full((B, Nt), 4.0)))
    hp = teng.HammerParams(x_H=t(np.full(B, 0.5)), w_H=t(np.full(B, 3000.0)),
                           M_r=t(np.full(B, 10.0)), alpha=t(np.full(B, 3.0)))
    zl = torch.zeros((B, M_l), dtype=torch.float64)
    carry = teng.Carry(u1=u0, u2=u0, z1=zl, z2=zl, uH1=t(np.full(B, uH1)),
                       uH2=t(np.full(B, -1e-3)))
    return carry, sp, bp, hp


def _grid(f0v, kappa, alpha, sr=SR):
    theta = fdm.get_theta(kappa, f0v, sr)
    _, _, nx_t, _, nx_l, _ = fdm.get_derived_vars_np(f0v, 0.0, 1.0 / sr, theta, 1.0, 1.0)
    _, _, N_t, _, _, _ = fdm.get_derived_vars_np(f0v, kappa, 1.0 / sr, theta, 1.0, alpha)
    return theta, nx_t + 1, nx_l + 1, N_t


def _run_mms(f0v, length, sr, centered):
    B, p_a, kappa = 1, 0.01, 0.03
    Nt = int(sr * length)
    theta, M_t, M_l, N_t = _grid(f0v, kappa, 1.0, sr)
    n_t = torch.full((B,), N_t + 1.0, dtype=torch.float64)
    x_grid = st.domain_x(M_t, torch.full((B,), float(N_t), dtype=torch.float64))
    u0 = st.mask_live(p_a * torch.cos(np.pi * x_grid) ** 2, n_t)
    carry, sp, bp, hp = _mk(B, Nt, f0v, kappa, 1.0, 20.0, p_a, 0.5, M_t, M_l, u0)
    consts = teng.SimConsts(k=1.0 / sr, theta_t=float(theta), lambda_c=1.0,
                            relative_error=8.0, M_t=M_t, M_l=M_l, manufactured=True,
                            mms_centered=centered)
    none = torch.zeros(B, dtype=torch.bool)
    _, out = teng.simulate_chunk(carry, range(2, Nt), sp, bp, hp, none, none, consts)
    gamma = 2 * f0v
    sig0 = float(fdm.t60_to_sigma(sp.T60, torch.tensor([gamma], dtype=torch.float64),
                                  torch.tensor([kappa * gamma], dtype=torch.float64))[0][0])
    x = np.linspace(-0.5, 0.5, N_t + 1)
    t = np.arange(2, Nt) / sr
    exact = (p_a * np.cos(np.pi * x)[None, :] ** 2 * np.cos(gamma * t)[:, None]
             * np.exp(-sig0 * t)[:, None])
    return np.abs(out["u"][:, 0, : N_t + 1].numpy() - exact).max() / p_a


def test_mms_tracks_closed_form_and_converges():
    """Twin of test_engine.py::test_mms_tracks_closed_form_and_converges
    over 10 ms instead of 50 (the bounds hold from the first periods on)."""
    err_coarse = _run_mms(220.0, 0.01, SR, True)
    err_fine = _run_mms(220.0, 0.01, 2 * SR, True)
    assert err_coarse < 0.02, err_coarse
    assert err_fine < err_coarse / 1.7, (err_fine, err_coarse)
    assert _run_mms(220.0, 0.01, SR, False) < 0.05


@pytest.mark.parametrize("excitation", ["pluck", "hammer", "bow"])
def test_excited_string_sounds(excitation):
    """Twins of test_engine.py's pluck, hammer and bow tests, cut to 20 ms
    (pluck) and 6 ms: the output is finite and rings; a pluck rings at the
    Fletcher stiff-string mode (880 Hz here, so 20 ms resolve it), the
    hammer exerts a force, the bow keeps the string moving."""
    B = 1
    f0v, kappa, length, pos = {"pluck": (880.0, 0.02, 0.02, 0.3),
                               "hammer": (146.0, 0.01, 0.006, 0.4),
                               "bow": (110.0, 0.01, 0.006, 0.4)}[excitation]
    Nt = int(SR * length)
    theta, M_t, M_l, N_t = _grid(f0v, kappa, 1.0)
    n_t = torch.full((B,), N_t + 1.0, dtype=torch.float64)
    if excitation == "pluck":
        u0 = st.mask_live(st.triangular(M_t, n_t, torch.full((B,), 0.4, dtype=torch.float64),
                                        torch.full((B,), 0.01, dtype=torch.float64)), n_t)
    else:
        u0 = torch.zeros((B, M_t), dtype=torch.float64)
    ramp = 0.2 * np.tanh(np.arange(Nt) / SR * 10.0)[None, :]
    carry, sp, bp, hp = _mk(
        B, Nt, f0v, kappa, 1.0, 20.0, 0.0, pos, M_t, M_l, u0,
        uH1=-1e-3 + K_STEP * 2.5 if excitation == "hammer" else -1e-3,
        **(dict(v_b=ramp, F_b=50.0, x_b=0.25) if excitation == "bow" else {}))
    consts = teng.SimConsts(k=K_STEP, theta_t=float(theta), lambda_c=1.0,
                            relative_error=4.0, M_t=M_t, M_l=M_l, collect_state=False)
    bm = torch.tensor([excitation == "bow"])
    hm = torch.tensor([excitation == "hammer"])
    _, out = teng.simulate_chunk(carry, range(2, Nt), sp, bp, hp, bm, hm, consts)
    wav = out["uout"][:, 0].numpy()
    assert np.isfinite(wav).all()
    assert np.abs(wav[-len(wav) // 4:]).max() > 1e-9  # still moving at the end
    if excitation == "pluck":
        n_fft = 16 * len(wav)  # zero padding: the peak to a fraction of a bin
        spec = np.abs(np.fft.rfft(wav * np.hanning(len(wav)), n=n_fft))
        peak = np.fft.rfftfreq(n_fft, K_STEP)[spec.argmax()]
        expected = fdm.stiff_string_modes(f0v, kappa, 1)[0][0]
        assert abs(peak - expected) / expected < 0.03, (peak, expected)
    if excitation == "hammer":
        assert out["F_H"][:, 0].max() > 0
