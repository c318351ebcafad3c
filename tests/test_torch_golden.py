"""The port's scan engine (float64) against the golden fixtures; its plain
string step's twin tests are ``tests/test_torch_golden_reference.py``.

``tests/golden/*.npz`` hold f64 outputs of the upstream libtorch engine
(see tests/test_golden_fixtures.py): plucked, bowed and hammered strings,
with the interpolated pickup readout (``bow_surface``: the surface
integral).  The states, the readout and the loss terms are held to each
fixture's own bound.  The port's engine (``core/engine.py``) meets every
fixture's bound, the bowed ones included, as the JAX engine does.  The
string step meets the unbowed ones; ``strong_coupling`` runs it with the
GMRES rescue on, which no step of it needs at f64 (readings 8.9e-7 in
state_u, 1.8e-8 in state_z, 5.3e-7 in uout, the same as without).

The bowed fixtures record the reference's Picard loop, which stops once an
iterate moves u by no more than h_t**relative_error (absolute, 2.3e-9
here).  The string kernel, on the TPU as in the port, iterates the bow's
friction fixed point to machine precision instead.  So the port departs
from the bowed fixtures by 7.4e-6 of scale at the first step, within the
fixture's bound, and its state_u by up to 3.4e-4 over the 958 steps, beyond
it (ROADMAP Queue 3).  The bowed inputs are therefore held twice: to the
fixture itself at bounds set from those readings, and to the JAX engine
with its Picard loop iterated to convergence (``relative_error=12``) at
1e-9 of scale.
"""

import os

import numpy as np
import pytest
import torch

from test_golden_fixtures import _cfg_from_fixture
from torch_fdtd_string_tpu_torch.core import engine as teng

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = ["bow", "bow_surface", "glide_pluck", "hammer", "linear_pluck",
            "nonlinear_pluck", "strong_coupling"]


def _run_engine(cfg, Nt):
    """The fixture's strings through the port's scan engine, as
    test_golden_reference.py::_run_ours runs the JAX engine."""
    t = lambda key: torch.as_tensor(np.asarray(cfg[key], np.float64))
    B, M_l = cfg["B"], cfg["M_l"]
    sp = teng.StringParams(kappa=t("kappa"), alpha=t("alpha"), p_a=t("p_a"), f0=t("f0"),
                           pos=t("pos"), T60=t("T60"))
    bp = teng.BowParams(x_b=t("x_b"), v_b=t("v_b"), F_b=t("F_b"), phi_0=t("phi_0"),
                        phi_1=t("phi_1"), wid=t("wid"))
    hp = teng.HammerParams(x_H=t("x_H"), w_H=t("w_H"), M_r=t("M_r"), alpha=t("alpha_H"))
    zl = torch.zeros((B, M_l), dtype=torch.float64)
    carry = teng.Carry(
        u1=t("u1"), u2=t("u2"), z1=zl, z2=zl,
        uH1=torch.full((B,), -1e-3 + cfg["k"] * cfg["v_H_amp"], dtype=torch.float64),
        uH2=torch.full((B,), -1e-3, dtype=torch.float64))
    consts = teng.SimConsts(
        k=cfg["k"], theta_t=cfg["theta_t"], lambda_c=cfg["lambda_c"],
        relative_error=float(cfg["relative_error"]), M_t=cfg["M_t"], M_l=M_l,
        surface_integral=bool(cfg["surface_integral"]), collect_state=True)
    _, out = teng.simulate_chunk(carry, range(2, Nt), sp, bp, hp,
                                 torch.tensor(cfg["bow_mask"]),
                                 torch.tensor(cfg["hammer_mask"]), consts)
    state_u = np.concatenate([cfg["u2"][:, None], cfg["u1"][:, None],
                              out["u"].numpy().transpose(1, 0, 2)], axis=1)
    state_z = np.concatenate([np.zeros((B, 2, M_l)), out["z"].numpy().transpose(1, 0, 2)],
                             axis=1)
    return (out["uout"].numpy().T, state_u, state_z, out["sig0"][-1].numpy(),
            out["sig1"][-1].numpy())


@pytest.mark.parametrize("name", FIXTURES)
def test_engine_matches_golden_fixture(name):
    """Twin of test_golden_fixtures.py::test_golden_fixture_parity on the
    port's engine: each fixture's bound (2e-5, or its own)."""
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    uout, state_u, state_z, sig0, sig1 = _run_engine(cfg, Nt)
    tol = float(z["tol"]) if "tol" in z.files else 2e-5
    du, dz, duo = _rel_errs(z["state_u"], z["state_z"], z["uout"][:, 2:], uout,
                            state_u, state_z)
    assert du < tol and dz < tol and duo < tol, (du, dz, duo)
    np.testing.assert_allclose(z["sig0"], sig0, rtol=1e-9)
    np.testing.assert_allclose(z["sig1"], sig1, rtol=1e-9, atol=1e-12)


def _rel_errs(want_u, want_z, want_uout, uout, state_u, state_z):
    """Relative errors of state_u, state_z (against max(|z|, |u|), as
    tests/test_golden_fixtures.py measures it) and uout."""
    scale = max(np.abs(want_u).max(), 1e-12)
    du = np.abs(want_u - state_u).max() / scale
    dz = np.abs(want_z - state_z).max() / max(np.abs(want_z).max(), scale)
    duo = np.abs(want_uout - uout).max() / max(np.abs(want_uout).max(), 1e-12)
    return du, dz, duo
