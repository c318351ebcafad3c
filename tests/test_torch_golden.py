"""The port's plain string step (float64) against the pluck golden fixtures.

``tests/golden/*.npz`` hold f64 outputs of the upstream libtorch engine
(see tests/test_golden_fixtures.py).  The states and loss terms are held to
each fixture's own bound.  The fixtures' readout is the interpolated pickup,
which waits for its ROADMAP Queue 2 item, so ``uout`` is not compared here;
``strong_coupling`` waits for the GMRES item, and the bow/hammer fixtures
for theirs.
"""

import os

import numpy as np
import pytest
import torch

from test_golden_fixtures import _cfg_from_fixture
from torch_fdtd_string_tpu_torch.ops import fdm
from torch_fdtd_string_tpu_torch.ops.string_kernel import string_chunked

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("name", ["linear_pluck", "nonlinear_pluck", "glide_pluck"])
def test_reference_matches_golden_fixture(name):
    z = np.load(os.path.join(HERE, "golden", f"{name}.npz"))
    cfg, Nt = _cfg_from_fixture(z)
    t = lambda key: torch.tensor(np.asarray(cfg[key]), dtype=torch.float64)
    B, M_t, M_l = cfg["B"], cfg["M_t"], cfg["M_l"]
    zeros = torch.zeros((B, M_l), dtype=torch.float64)
    f0 = t("f0")
    _, _, aux = string_chunked(
        f0[:, 2:Nt].contiguous(), t("kappa"), t("alpha"), t("pos"), t("T60"),
        t("u1"), t("u2"), zeros, zeros,
        k=cfg["k"], theta_t=cfg["theta_t"], lambda_c=cfg["lambda_c"],
        M_t=M_t, M_l=M_l, coupling_iters=24, surface_integral=True,
        collect_state=True, gmres_rescue=False,
    )
    state_u = np.concatenate(
        [cfg["u2"][:, None], cfg["u1"][:, None],
         aux["state_u"].numpy().transpose(1, 0, 2)], axis=1)
    state_z = np.concatenate(
        [np.zeros((B, 2, M_l)), aux["state_z"].numpy().transpose(1, 0, 2)], axis=1)
    gamma = 2.0 * f0[:, -1]
    sig0, sig1 = fdm.t60_to_sigma(t("T60"), gamma, t("kappa") * gamma)

    tol = float(z["tol"]) if "tol" in z.files else 2e-5
    scale = max(np.abs(z["state_u"]).max(), 1e-12)
    du = np.abs(z["state_u"] - state_u).max() / scale
    dz = np.abs(z["state_z"] - state_z).max() / max(np.abs(z["state_z"]).max(), scale)
    assert du < tol, f"state_u rel err {du}"
    assert dz < tol, f"state_z rel err {dz}"
    np.testing.assert_allclose(z["sig0"], sig0.numpy(), rtol=1e-9)
    np.testing.assert_allclose(z["sig1"], sig1.numpy(), rtol=1e-9, atol=1e-12)
