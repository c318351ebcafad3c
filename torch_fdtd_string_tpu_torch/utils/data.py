"""Training-data file I/O (numpy host side).

Port of the parts of ``torch_fdtd_string_tpu/utils/data.py`` that the fused
dataset path uses: the cached spline operators that resample a string's
state to the training grid, and the per-x wav layout written by
preprocessing (``ut-{x}.wav`` / ``ua-{x}.wav`` / ``vt.wav`` +
``parameters.npz``, reference ``src/utils/data.py``), and ``load_wav``, the
per-item reader of the DMSP datasets (``data/dataset.py``).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from . import wav as wavio

_SPLINE_MAT_CACHE = {}
_SPLINE_LOCK = threading.Lock()


def spline_matrix(n_in, n_out, k=5):
    """(n_out, n_in) interpolating-spline operator on uniform [0, 1] grids.

    Spline interpolation at fixed knots is linear in the data, so
    resampling (Nt, n_in) -> (Nt, n_out) is one GEMM with this cached
    matrix; it is the reference's RectBivariateSpline
    (process_training_data.py:136-149) evaluated at the time knots, where
    the tensor spline reduces to the 1-D x-spline.
    """
    key = (int(n_in), int(n_out), int(k))
    with _SPLINE_LOCK:
        mat = _SPLINE_MAT_CACHE.get(key)
    if mat is None:
        from scipy.interpolate import make_interp_spline

        k_eff = max(min(k, n_in - 1), 1)
        xu = np.linspace(0.0, 1.0, n_in)
        xi = np.linspace(0.0, 1.0, n_out)
        spl = make_interp_spline(xu, np.eye(n_in), k=k_eff, axis=0)
        mat = np.ascontiguousarray(spl(xi), np.float32)  # (n_out, n_in)
        with _SPLINE_LOCK:
            mat = _SPLINE_MAT_CACHE.setdefault(key, mat)
    return mat


def upsample_columns(ut, widths, n_out, k=5):
    """Spline-resample each row of ``ut`` from its live width to ``n_out``.

    ut: (Nt, M) state rows; widths: (Nt,) live column count per row.  Rows
    are grouped by width (f0 moves slowly, so a handful of widths occur)
    and each group is one GEMM against the cached spline matrix.
    """
    ut = np.asarray(ut)
    widths = np.asarray(widths, np.int64)
    out = np.empty((ut.shape[0], n_out), np.float32)
    for w in np.unique(widths):
        rows = np.nonzero(widths == w)[0]
        out[rows] = ut[rows, :w].astype(np.float32) @ spline_matrix(w, n_out, k).T
    return out


def save(dir_path, data_dict, sr=48000):
    """Write per-x wavs + parameters.npz (reference data.py:59-79).

    ``ut``/``zt``/``ua`` (Nt, Nx) become one PCM_24 wav per column and
    ``vt`` one wav; every other entry that is not a Python scalar goes into
    ``parameters.npz``, written under a temporary name and renamed, so a
    killed writer never leaves a truncated file.
    """
    os.makedirs(dir_path, exist_ok=True)
    rest = dict(data_dict)
    for key, val in data_dict.items():
        if isinstance(val, (float, int)):
            continue
        arr = np.asarray(val).squeeze()
        if key in ("ut", "zt", "ua"):
            Nt, Nx = arr.shape
            if min(Nt, Nx) <= 1:
                raise ValueError(f"{key} must be (Nt, Nx) with both > 1, got {arr.shape}")
            wavio.write_columns(
                [f"{dir_path}/{key}-{xi}.wav" for xi in range(Nx)],
                arr, sr, "PCM_24",
            )
            rest.pop(key)
        elif key == "vt":
            wavio.write(f"{dir_path}/vt.wav", arr, sr, "PCM_24")
            rest.pop(key)
    tmp_path = f"{dir_path}/.parameters.tmp.npz"  # np.savez keeps the suffix
    np.savez(tmp_path, **rest)
    os.replace(tmp_path, f"{dir_path}/parameters.npz")


def load_wav(wav_path, npz_path, trim=None, keys=("t", "kappa", "alpha"),
             gain=1.0, wav=None):
    """Load one target wav + selected parameter keys (reference data.py:9-22).

    ``trim = (start, end)`` cuts the target and the ``t`` key; ``wav`` lets
    a caller that already read the file pass the samples in."""
    out = {}
    res = np.load(npz_path)
    for key in keys:
        val = res[key]
        if trim is not None and key == "t":
            val = val[trim[0]:trim[1]]
        out[key] = val
    w = wavio.read(wav_path)[0] if wav is None else wav
    out["target"] = gain * (w[trim[0]:trim[1]] if trim is not None else w)
    return out
