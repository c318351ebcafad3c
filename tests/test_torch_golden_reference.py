"""The port's plain string step (float64) against the golden fixtures.

The twin of ``tests/test_torch_golden.py`` (the scan engine) for the
plain PyTorch version of the string kernel, ``ops/string_kernel.py::
string_chunked`` on the CPU: the unbowed fixtures at their own bounds,
``strong_coupling`` with the GMRES rescue on (readings 8.9e-7 in state_u,
1.8e-8 in state_z, 5.3e-7 in uout, the same as without), and the bowed
fixtures held twice, to the fixture at bounds set from the readings and to
the JAX engine with its Picard loop converged at 1e-9 of scale (why:
``tests/test_torch_golden.py``'s docstring).
"""

import os

import numpy as np
import pytest
import torch

from test_golden_fixtures import _cfg_from_fixture
from test_golden_reference import _run_ours
from test_torch_golden import HERE, _rel_errs
from torch_fdtd_string_tpu_torch.ops import fdm
from torch_fdtd_string_tpu_torch.ops.string_kernel import string_chunked


def test_reference_gmres_on_strong_coupling_fixture():
    """alpha=23, f0=392: the plain string step with the GMRES rescue on,
    within the fixture's bound (module docstring for the readings)."""
    z = np.load(os.path.join(HERE, "golden", "strong_coupling.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    uout, state_u, state_z = _run_port(cfg, Nt, gmres_rescue=True)
    tol = float(z["tol"]) if "tol" in z.files else 2e-5
    du, dz, duo = _rel_errs(z["state_u"], z["state_z"], z["uout"][:, 2:], uout,
                            state_u, state_z)
    assert du < tol and dz < tol and duo < tol, (du, dz, duo)


def _run_port(cfg, Nt, gmres_rescue=False):
    """The fixture's strings through the port's plain string step; returns
    uout (B, Nt-2) and the (B, Nt, M) state fields, initial rows first."""
    t = lambda key: torch.tensor(np.asarray(cfg[key]), dtype=torch.float64)
    sig = lambda key: t(key)[:, 2:Nt].contiguous()
    B, M_t, M_l = cfg["B"], cfg["M_t"], cfg["M_l"]
    zeros = torch.zeros((B, M_l), dtype=torch.float64)
    # the initial hammer displacements of test_golden_reference.py::_run_ours
    uH = dict(uH1=torch.full((B,), -1e-3 + cfg["k"] * cfg["v_H_amp"], dtype=torch.float64),
              uH2=torch.full((B,), -1e-3, dtype=torch.float64))
    bow = hammer = None
    if cfg["bow_mask"].any():
        bow = dict(x_b=sig("x_b"), v_b=sig("v_b"), F_b=sig("F_b"), wid=sig("wid"),
                   phi_0=t("phi_0"), phi_1=t("phi_1"),
                   mask=torch.tensor(cfg["bow_mask"]), **uH)
    if cfg["hammer_mask"].any():
        hammer = dict(x_H=t("x_H"), w_H=t("w_H"), M_r=t("M_r"), alpha=t("alpha_H"),
                      mask=torch.tensor(cfg["hammer_mask"]), **uH)
    uout, _, aux = string_chunked(
        sig("f0"), t("kappa"), t("alpha"), t("pos"), t("T60"),
        t("u1"), t("u2"), zeros, zeros,
        k=cfg["k"], theta_t=cfg["theta_t"], lambda_c=cfg["lambda_c"],
        M_t=M_t, M_l=M_l, coupling_iters=24,
        surface_integral=cfg["surface_integral"],
        relative_error=cfg["relative_error"], collect_state=True,
        gmres_rescue=gmres_rescue, bow=bow, hammer=hammer,
    )
    state_u = np.concatenate(
        [cfg["u2"][:, None], cfg["u1"][:, None],
         aux["state_u"].numpy().transpose(1, 0, 2)], axis=1)
    state_z = np.concatenate(
        [np.zeros((B, 2, M_l)), aux["state_z"].numpy().transpose(1, 0, 2)], axis=1)
    return uout.numpy(), state_u, state_z


@pytest.mark.parametrize("name", ["linear_pluck", "nonlinear_pluck", "glide_pluck",
                                  "hammer"])
def test_reference_matches_golden_fixture(name):
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    uout, state_u, state_z = _run_port(cfg, Nt)
    t = lambda key: torch.tensor(np.asarray(cfg[key]), dtype=torch.float64)
    gamma = 2.0 * t("f0")[:, -1]
    sig0, sig1 = fdm.t60_to_sigma(t("T60"), gamma, t("kappa") * gamma)

    tol = float(z["tol"]) if "tol" in z.files else 2e-5
    du, dz, duo = _rel_errs(z["state_u"], z["state_z"], z["uout"][:, 2:],
                            uout, state_u, state_z)
    assert du < tol, f"state_u rel err {du}"
    assert dz < tol, f"state_z rel err {dz}"
    assert duo < tol, f"uout rel err {duo}"
    np.testing.assert_allclose(z["sig0"], sig0.numpy(), rtol=1e-9)
    np.testing.assert_allclose(z["sig1"], sig1.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["bow", "bow_surface"])
def test_reference_matches_converged_engine_on_bow_fixture(name):
    """The bowed fixtures' strings: the port against the JAX engine with its
    Picard loop converged, states and uout within 1e-9 of scale (see the
    module docstring for why not against the fixture itself)."""
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    cfg["relative_error"] = 12.0  # h_t**12 lies below f64 resolution of u
    want = _run_ours(cfg, Nt)
    uout, state_u, state_z = _run_port(cfg, Nt)
    du, dz, duo = _rel_errs(want["state_u"], want["state_z"],
                            want["uout"][:, : Nt - 2], uout, state_u, state_z)
    assert du < 1e-9 and dz < 1e-9 and duo < 1e-9, (du, dz, duo)


@pytest.mark.parametrize("name", ["bow", "bow_surface"])
def test_reference_tracks_bow_fixture(name):
    """The bowed fixtures at their own relative_error: the first computed
    step and state_z over the whole run within the fixture's bound; state_u
    and uout over all 958 steps within 1e-3 of scale (readings 3.4e-4 and
    2.7e-4, 5.4e-4 with the surface integral), the drift the bow's looser
    Picard stop leaves in the fixture (module docstring)."""
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    uout, state_u, state_z = _run_port(cfg, Nt)
    tol = float(z["tol"]) if "tol" in z.files else 2e-5
    du, dz, duo = _rel_errs(z["state_u"], z["state_z"], z["uout"][:, 2:],
                            uout, state_u, state_z)
    du_first = np.abs(z["state_u"][:, 2] - state_u[:, 2]).max() / np.abs(z["state_u"]).max()
    assert du_first < tol, f"first-step state_u rel err {du_first}"
    assert dz < tol, f"state_z rel err {dz}"
    assert du < 1e-3 and duo < 1e-3, (du, duo)
