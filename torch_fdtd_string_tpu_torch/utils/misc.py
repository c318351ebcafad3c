"""Host-side miscellany: artifact bundling, naming, small array helpers.

Counterpart of reference ``src/utils/misc.py`` (the tensor primitives live in
``ops/stencils.py``; this module keeps the file-format / bookkeeping side).
"""

from __future__ import annotations

import os

import numpy as np
import yaml

_CHARS = list("0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")


def random_str(length=8, rng=None):
    rng = rng or np.random.default_rng()
    return "".join(rng.choice(_CHARS, length))


def ell_infty_normalize(x, normalize_dims=1):
    from .audio import ell_infty_normalize as f

    return f(x, normalize_dims)


def downsample(x, factor=None, size=None):
    """Linear-resample (B, Nt) -> (B, size) (reference misc.py:308-315)."""
    x = np.asarray(x)
    if size is None:
        size = x.shape[1] // factor + bool(x.shape[1] % factor)
    src = np.linspace(0, x.shape[1] - 1, size)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, x.shape[1] - 1)
    frac = src - lo
    return x[:, lo] * (1 - frac) + x[:, hi] * frac


def save_simulation_data(directory, excitation_type, overall_results, constants):
    """Write the 4 npz bundles + short yaml (reference misc.py:235-299).

    ``overall_results`` carries ``string_params``/``hammer_params``/
    ``bow_params`` lists in the reference's positional order.
    """
    os.makedirs(directory, exist_ok=True)
    results = dict(overall_results)
    string_params = results.pop("string_params")
    hammer_params = results.pop("hammer_params")
    bow_params = results.pop("bow_params")

    string_dict = {
        "kappa": string_params[0],
        "alpha": string_params[1],
        "u0": string_params[2],
        "v0": string_params[3],
        "p_a": string_params[4],
        "f0": string_params[5],
        "pos": string_params[6],
        "T60": string_params[7],
        "target_f0": string_params[8],
    }
    hammer_dict = {
        "x_H": hammer_params[0],
        "v_H": hammer_params[1],
        "u_H": hammer_params[2],
        "w_H": hammer_params[3],
        "M_r": hammer_params[4],
        "alpha": hammer_params[5],
    }
    bow_dict = {
        "x_B": bow_params[0],
        "v_B": bow_params[1],
        "F_B": bow_params[2],
        "phi_0": bow_params[3],
        "phi_1": bow_params[4],
        "wid_B": bow_params[5],
    }

    def sample(val):
        arr = np.asarray(val)
        return arr.flat[0].item() if arr.size else None

    short = {
        "excitation_type": excitation_type,
        "theta_t": float(constants[1]),
        "lambda_c": float(constants[2]),
        "value-string": {k: sample(v) for k, v in string_dict.items()},
        "value-hammer": {k: sample(v) for k, v in hammer_dict.items()},
        "value-bow": {k: sample(v) for k, v in bow_dict.items()},
    }

    np.savez_compressed(f"{directory}/simulation.npz", **results)
    np.savez_compressed(f"{directory}/string_params.npz", **string_dict)
    np.savez_compressed(f"{directory}/hammer_params.npz", **hammer_dict)
    np.savez_compressed(f"{directory}/bow_params.npz", **bow_dict)
    with open(f"{directory}/simulation_config.yaml", "w") as f:
        yaml.dump(short, f, default_flow_style=False)
