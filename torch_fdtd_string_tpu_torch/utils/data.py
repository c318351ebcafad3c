"""Training-data file I/O and collation (numpy host side).

Port of ``torch_fdtd_string_tpu/utils/data.py`` (reference
``src/utils/data.py``): the spline resamplers of a string's state
(``interpolate``, ``interpolate1d`` and the cached GEMM operators of the
dataset paths), the per-x wav layout written by preprocessing
(``ut-{x}.wav`` / ``ua-{x}.wav`` / ``vt.wav`` + ``parameters.npz``) with
its writer ``save`` and readers ``load`` and ``load_wav`` (the DMSP
datasets' per-item reader), and the collation helpers ``set_length`` and
``stack_batch``.
"""

from __future__ import annotations

import glob
import os
import threading

import numpy as np

from . import wav as wavio

def interpolate(u, taxis, xaxis, xvals, kx=5, ky=5):
    """2-D spline resample along space (reference misc.py:138-146).

    u: (Nt, Nx_in); taxis: (Nt, 1) or (Nt,); xaxis: (1, Nx_in); xvals:
    (Nx_out,).  Returns (Nt, Nx_out).
    """
    from scipy.interpolate import RectBivariateSpline

    taxis = np.asarray(taxis).reshape(-1)
    xaxis = np.asarray(xaxis).reshape(-1)
    xvals = np.asarray(xvals).reshape(-1)
    kx_eff = min(kx, len(taxis) - 1) if len(taxis) > 1 else 1
    ky_eff = min(ky, len(xaxis) - 1)
    rbs = RectBivariateSpline(taxis, xaxis, u, kx=max(kx_eff, 1), ky=max(ky_eff, 1))
    return rbs(taxis, xvals, grid=True)


def interpolate1d(u, xaxis, xvals, k=5):
    """1-D spline resample (reference misc.py:128-136). u: (1, Nx) -> (1, Nx_out)."""
    from scipy.interpolate import make_interp_spline

    xaxis = np.asarray(xaxis).reshape(-1)
    xvals = np.asarray(xvals).reshape(-1)
    k_eff = min(k, len(xaxis) - 1)
    spl = make_interp_spline(xaxis, np.asarray(u).reshape(-1), k=max(k_eff, 1))
    return spl(xvals)[None, :]


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


def load(dir_path, n_subsample=None, sr=48000, wav_keys=("ut", "zt", "ua"),
         subsample_method="sequential", rng=None):
    """A spatial stack of per-x wavs and the item's parameters (reference
    data.py:24-57): ``{prefix: (Nt, Nx)}`` for each of ``wav_keys`` and
    every key of ``parameters.npz``.  ``n_subsample`` columns are taken at
    random (``"random"``) or as a run from a random start."""
    rng = rng or np.random.default_rng()
    out = {}
    for prefix in wav_keys:
        max_N = len(glob.glob(f"{dir_path}/{prefix}-*.wav"))
        paths = [f"{dir_path}/{prefix}-{i}.wav" for i in range(max_N)]
        if n_subsample is not None:
            if subsample_method == "random":
                if max_N < n_subsample:
                    idx = rng.integers(0, max_N, size=n_subsample)
                else:
                    idx = rng.permutation(max_N)[:n_subsample]
            else:
                r = rng.integers(0, max(max_N - n_subsample, 1))
                idx = np.arange(r, r + n_subsample)
            paths = [paths[i] for i in idx]
        out[prefix] = np.stack([wavio.read(p)[0] for p in paths], axis=1)
    res = np.load(f"{dir_path}/parameters.npz")
    for key in res.keys():
        out[key] = res[key]
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


def set_length(x, size, method="pad", idx_x=None):
    """Pad (``"pad"``), linearly resample (``"interpolate"``) or index
    (``"random"``, with ``idx_x``) the last axis to ``size`` (reference
    data.py:81-107)."""
    x = np.asarray(x)
    n = x.shape[-1]
    if method == "interpolate":
        if n == size:
            return x
        src = np.linspace(0, n - 1, size)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        frac = src - lo
        return x[..., lo] * (1 - frac) + x[..., hi] * frac
    if method == "pad":
        if n > size:
            raise ValueError(f"set Nx (={size}) >= {n}")
        if n == size:
            return x
        out = np.zeros(x.shape[:-1] + (size,), x.dtype)
        out[..., :n] = x
        return out
    if method == "random":
        if idx_x is None:
            raise ValueError("method='random' needs idx_x")
        return np.take(x, idx_x, axis=-1)
    raise ValueError(f"unknown method {method!r}")


# the per-item keys stack_batch cuts in time, and those it sets in space
TIME_VARS = frozenset({
    "u_gt", "z_gt", "u_in", "z_in", "f0", "Nu", "Nz",
    "x_B", "v_B", "F_B", "wid_B", "v_H", "u_H", "uat", "uar", "tt",
})
SPACE_VARS = frozenset({"u_gt", "z_gt", "u_in", "z_in", "uat", "uar", "u0", "z0", "xt"})


def stack_batch(batch, Nx, Nt=None, sr=48000, x_method="interpolate",
                t_method="sequential", start_time=None, end_time=None,
                rng=None):
    """Collate a list of per-item dicts with time and space subsampling
    (reference data.py:109-211): ``Nt`` steps from a random start (or
    ``start_time``) by ``t_method`` (``"sequential"``, ``"interpolate"``,
    ``"interleave"``), ``Nx`` points by ``x_method`` (:func:`set_length`).
    ``end_time`` is accepted for the reference's signature and unused."""
    rng = rng or np.random.default_rng()
    Bs = len(batch)
    out = {}

    idx_x = None
    if x_method == "random":
        n = batch[0]["u_in"].shape[-1]
        idx_x = rng.integers(0, n, Nx) if n < Nx else rng.permutation(n)[:Nx]

    T = batch[0]["u_in"].shape[0]
    if Nt is not None:
        if start_time is None:
            st = rng.integers(0, T - Nt, Bs) if T - Nt > 0 else np.zeros(Bs, int)
        else:
            st = int(start_time * sr) * np.ones(Bs, int)
    else:
        st = np.zeros(Bs, int)
        Nt = T

    for key in batch[0].keys():
        vals = [np.asarray(x[key]) for x in batch]
        if key in TIME_VARS:
            if t_method == "sequential":
                vals = [v[st[i]:st[i] + Nt] for i, v in enumerate(vals)]
            elif t_method == "interpolate":
                vals = [set_length(v[st[i]:].T if v.ndim > 1 else v[st[i]:], Nt,
                                   "interpolate") for i, v in enumerate(vals)]
                vals = [v.T if v.ndim > 1 else v for v in vals]
            elif t_method == "interleave":
                vals = [v[st[i]:][::max((T - st[i]) // Nt, 1)][:Nt]
                        for i, v in enumerate(vals)]
        if key in SPACE_VARS:
            vals = [set_length(v, Nx, x_method, idx_x=idx_x) for v in vals]
        out[key] = np.stack(vals)
    return out
