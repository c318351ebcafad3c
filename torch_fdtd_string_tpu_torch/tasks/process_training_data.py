"""Preprocess simulation results into DMSP training data.

Port of ``torch_fdtd_string_tpu/tasks/process_training_data.py`` (reference
``src/task/process_training_data.py``).  Per simulation directory of the
classic archival contract: spatially upsample the string's FDTD field to
the training grid, compute the analytic modal solution (mode frequencies
and shapes), synthesise the modal target, track f0 of both, and write the
per-x wav layout and ``parameters.npz`` that the DMSP datasets read.

Splines, root finding and f0 tracking run on the host (numpy, scipy); the
modal cosine bank runs on the device the caller gives
(``ops/modal.py::modal_synth_nyquist``: the card, or the CPU with
``proc.cpu=true``), or on the host (``device_synth=False``: the fused
dataset path's host build, ``tasks/simulate.py``).

    python -m torch_fdtd_string_tpu_torch.run experiment=process_training_data \\
        task.result_dir=<simulation run> task.save_dir=<prepared dir>
"""

from __future__ import annotations

import math
import os
from glob import glob

import numpy as np
import torch
import yaml

from ..core import analytic
from ..ops import fdm
from ..ops.modal import modal_synth_nyquist, modal_synth_nyquist_np
from ..utils import audio, data
from ..utils.frequency import compute_harmonic_parameters
from .simulate import select_device


def is_processed(directory, N):
    """Whether ``directory`` holds a complete item of ``N`` columns, so a
    restarted run skips it (reference process_training_data.py:17-27)."""
    if not os.path.exists(directory):
        return False
    if len(glob(f"{directory}/ut-*.wav")) != N:
        return False
    if len(glob(f"{directory}/ua-*.wav")) != N:
        return False
    if len(glob(f"{directory}/vt.wav")) != 1:
        return False
    return os.path.exists(f"{directory}/parameters.npz")


def _rms(x, eps=1e-18):
    m = np.mean(x**2)
    return 1.0 if m < eps else np.sqrt(m)


def load_data(dirs):
    """The four npz bundles of a simulation directory as dicts:
    ``simulation``, ``string_params``, ``bow_params``, ``hammer_params``."""
    out = []
    for name in ("simulation", "string_params", "bow_params", "hammer_params"):
        npz = np.load(f"{dirs}/{name}.npz")
        out.append({k: npz[k] for k in npz.keys()})
    return out


def t60_to_sigma_tv(T60, f0, K):
    """Time-varying (sig0, sig1) from per-sample f0 (reference
    process_training_data.py:65-84).  f0, K: (Nt,); T60: (2,2)."""
    gamma = 2.0 * f0
    zeta1 = -(gamma**2) + np.sqrt(
        gamma**4 + 4 * K**2 * (2 * math.pi * T60[0, 0]) ** 2
    )
    zeta2 = -(gamma**2) + np.sqrt(
        gamma**4 + 4 * K**2 * (2 * math.pi * T60[1, 0]) ** 2
    )
    sig0 = 6 * math.log(10) * (-zeta2 / T60[0, 1] + zeta1 / T60[1, 1]) / (zeta1 - zeta2)
    sig1 = 6 * math.log(10) * (1 / T60[0, 1] - 1 / T60[1, 1]) / (zeta1 - zeta2)
    return sig0, sig1


def build_processed(_sim, _str, _bow, _ham, theta_t, lambda_c, sr, Nx,
                    strict=True, device_synth=True, x_keep=None, device=None):
    """One processed training item from the four artifact dicts (the npz
    bundles' schema, reference misc.py:235-299); ``_sim["state_u"]`` is the
    item's (Nt, w) transverse state at its native width.

    ``device_synth`` runs the modal cosine bank on ``device`` (None: the
    card, which raises on a host without one), else on the host.
    ``x_keep`` restricts the saved spatial columns (``task.save_x_stride``);
    the f0 tracks, gain and ``vt`` stay on the full grid.  The dicts are
    updated in place and merged into the returned dict.
    """
    if device_synth and device is None:
        device = select_device()
    ut = _sim["state_u"]  # (Nt, Nu)
    f0 = _str["f0"]  # (Nt,)
    kr = float(_str["kappa"])
    ts = _str["T60"]  # (2, 2)
    k = 1.0 / sr
    # the widths in the simulator's dtype with the engine's guarded floor,
    # so the live slice cannot be off by one at a floor() boundary
    wdt = np.float64 if ut.dtype == np.float64 else np.float32
    nx_t = fdm.grid_widths_np(f0, kr, k, theta_t, lambda_c, dtype=wdt)

    Nt, Nu = ut.shape
    ki = max(min(5, int(nx_t.min()) - 1), 1)
    xi = np.linspace(0, 1, Nx)
    ti = np.arange(Nt, dtype=np.float64)[:, None] / sr

    # --- upsample the FDTD field to the fixed Nx grid --------------------
    widths = np.minimum(nx_t.astype(np.int64) + 1, Nu)[:Nt]
    ut = data.upsample_columns(ut, widths, Nx, k=ki)

    # --- analytic modal solution at Na, resampled to Nx ------------------
    Na = 1024
    u0_a = ut[0] @ data.spline_matrix(Nx, Na, k=ki).T
    _, mode_freq, mode_amps = analytic.lossy_stiff_string(
        u0_a, f0, kr, ts, Nt, Na, sr, strict=strict, return_field=False
    )
    mode_amps = mode_amps @ data.spline_matrix(Na, Nx, k=5).T  # (n_modes, Nx)

    # --- time-varying modal frequencies (linear FM by f0 drift) ----------
    omega = f0 / sr * (2 * math.pi)  # rad/sample
    romg = omega - omega[0]  # (Nt,)
    mode_freq_tv = mode_freq[None, :] + romg[:, None]  # (Nt, n_modes)

    sig0_tv, _ = t60_to_sigma_tv(ts, f0, 2 * f0 * kr)
    damping = np.exp(-ti[:, 0] * sig0_tv)  # (Nt,)
    if device_synth:
        # the bank in float32, as the JAX package runs it; the phase sums
        # the float64 increments in float64 (modal_synth_nyquist)
        ua = modal_synth_nyquist(
            torch.as_tensor(mode_freq_tv[None], dtype=torch.float64, device=device),
            torch.as_tensor(mode_amps.T[:, None, :], dtype=torch.float32, device=device),
            torch.as_tensor(damping[None, :, None], dtype=torch.float32, device=device),
            float(sr),
        )[:, :, 0].T.cpu().numpy()  # (Nt, Nx)
    else:
        ua = modal_synth_nyquist_np(mode_freq_tv, mode_amps.T, damping, sr)

    # --- f0 tracks of summed fields --------------------------------------
    uas = ua.sum(axis=1)
    uts = ut.sum(axis=1)
    ua_f0 = compute_harmonic_parameters(uas / _rms(uas), sr)["f0"]
    ut_f0 = compute_harmonic_parameters(uts / _rms(uts), sr)["f0"]

    gain = audio.ell_infty_normalize(ut.flatten())[1]
    vt = audio.state_to_wav(ut[None])[0]

    # u0 stays on the FULL training grid (the IC input whose argmax
    # recovers p_x); capture it before any pickup-subset slicing
    u0_full = ut[0][None, :].copy()

    if x_keep is not None:
        x_keep = np.asarray(x_keep, np.int64)
        ut = ut[:, x_keep]
        ua = ua[:, x_keep]
        mode_amps = mode_amps[:, x_keep]
        xi = xi[x_keep]

    _str.pop("v0", None)
    _sim.pop("state_u", None)
    _sim.pop("state_z", None)
    _sim.update(
        ua_f0=ua_f0,
        ut_f0=ut_f0,
        mode_freq=mode_freq,
        mode_amps=mode_amps,
        x=xi[None, :],
        t=ti,
        ut=ut,
        ua=ua,
        vt=vt,
        gain=float(np.asarray(gain).squeeze()),
    )
    _str.update(u0=u0_full)
    _bow["ph0_B"] = _bow.pop("phi_0")
    _bow["ph1_B"] = _bow.pop("phi_1")
    _bow["wid_B"] = _bow.pop("wid_B")
    _ham["M_H"] = _ham.pop("M_r")
    _ham["a_H"] = _ham.pop("alpha")

    overall = {}
    overall.update(_sim)
    overall.update(_str)
    overall.update(_bow)
    overall.update(_ham)
    return overall


def save_upsampled_data(load_dir, save_dir, sr, Nx, strict=True, device=None):
    """Process one simulation directory into ``save_dir`` (reference
    process_training_data.py:30-223); the cosine bank on ``device`` (None:
    the card).  Returns 1, or 0 for a directory without the npz bundles."""
    try:
        _sim, _str, _bow, _ham = load_data(load_dir)
    except FileNotFoundError:
        print(f"[preprocess] missing npz bundles in {load_dir}; skipping")
        return 0
    with open(f"{load_dir}/simulation_config.yaml") as f:
        constants = yaml.safe_load(f)
    overall = build_processed(
        _sim, _str, _bow, _ham, constants["theta_t"], constants["lambda_c"],
        sr, Nx, strict=strict, device=device,
    )
    data.save(save_dir, overall, sr=sr)
    return 1


def process(args):
    """Process every simulation directory of ``<root_dir>/<result_dir>``
    into ``<root_dir>/<save_dir>`` (reference process_training_data.py:
    225-242), on the card unless ``proc.cpu=true``.  With
    ``task.data_split`` > 1 this call takes every ``data_split``-th
    directory from ``task.split_n``; items already complete are skipped,
    so a restarted run goes on where it stopped.  Returns the number of
    items processed by this call."""
    task = args.task
    device = select_device(args.proc.cpu)
    path_to_dir = os.path.join(task.root_dir, task.result_dir)
    subdirs = sorted(
        d for d in glob(f"{path_to_dir}/*")
        if os.path.isdir(d) and "codes" not in d and "_frames" not in d
    )
    if task.data_split > 1:
        subdirs = subdirs[task.split_n::task.data_split]
    done = 0
    for subdir in subdirs:
        save_dir = subdir.replace(task.result_dir, task.save_dir)
        os.makedirs(save_dir, exist_ok=True)
        if is_processed(save_dir, task.Nx):
            continue
        done += save_upsampled_data(subdir, save_dir, task.sr, task.Nx, task.strict,
                                    device=device)
    print(f"[preprocess] {done} of {len(subdirs)} directories processed into "
          f"{os.path.join(task.root_dir, task.save_dir)}")
    return done
