"""Build preset ``.npy`` control files from a recording.

Port of ``torch_fdtd_string_tpu/tasks/preprocess_data.py`` (reference
``data/preprocess_data.py``): from ``<root_dir>/<name>/input.wav``, an f0
trajectory (YIN in place of CREPE), a bowing-force envelope from the
running RMS amplitude and hammer strike impulses from onset detection,
written as ``string-f0.npy``, ``bow-F_b.npy`` and ``hammer-v_H.npy``, which
a simulation reads through ``task.load_config=<root_dir>/<name>``
(``tasks/simulate.py::load_presets``), and ``sine-f0.wav``, a sine at the
tracked f0 to audition it.  :func:`process` also draws ``spec.pdf``, the
recording's rainbowgram under its f0 track, as the JAX package's does by
default (``plot=True``, which needs matplotlib).  The command line writes
the presets alone, so that it runs on a host without matplotlib:

    python -m torch_fdtd_string_tpu_torch.tasks.preprocess_data <root_dir> <name>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..utils import plot as uplot
from ..utils import wav as wavio
from ..utils.audio import stft_mag
from ..utils.frequency import track_f0


def get_amplitude(x, n_fft=1024, hop=256):
    """Frame RMS amplitude from an STFT (reference preprocess_data.py:115-118)."""
    mag = stft_mag(x[None, :], n_fft, hop)[0]  # (frames, bins)
    return np.sqrt(np.mean(mag**2, axis=-1) + 1e-5)


def running_avg(x, N=1024, threshold=0.3):
    """Gated running average (reference preprocess_data.py:135-139)."""
    w = np.pad(np.ones(N) / N, (N, 0))
    x = np.where(x > threshold, x, 0.0)
    return np.convolve(x, w, mode="same")


def onset_impulses(x, sr, hop=512, pre=8, delta_rel=0.3):
    """Spectral-flux onsets as a sample-rate impulse train: a 1 at the first
    sample of each onset frame (in place of the reference's librosa onset
    detection, preprocess_data.py:183-191)."""
    mag = stft_mag(x[None, :], 2048, hop)[0]  # (frames, bins)
    flux = np.maximum(np.diff(np.log1p(mag), axis=0), 0.0).mean(axis=-1)
    flux = np.concatenate([[0.0], flux])
    if flux.max() <= 0:
        return np.zeros_like(x)
    thresh = delta_rel * flux.max()
    onsets = []
    last = -pre
    for i in range(1, len(flux) - 1):
        if flux[i] >= thresh and flux[i] >= flux[i - 1] and flux[i] >= flux[i + 1]:
            if i - last >= pre:
                onsets.append(i)
                last = i
    hammer = np.zeros(len(x))
    for f in onsets:
        hammer[min(f * hop, len(x) - 1)] = 1.0
    return hammer


def sine_like(freqs, length, sr):
    """Phase-accumulated sine at the tracked f0 (reference preprocess_data.py:120-125)."""
    t1 = np.arange(length) / sr
    t2 = np.linspace(1 / sr, length / sr, freqs.shape[-1])
    f = np.interp(t1, t2, freqs)
    return np.sin(2 * np.pi * np.add.accumulate(f) / sr)


def process(root_dir, filename, target_sr=48000, plot=True):
    """Write the presets of ``{root_dir}/{filename}/input.wav`` beside it,
    and with ``plot`` (the JAX package's default; it needs matplotlib) the
    recording's rainbowgram with its f0 track, ``spec.pdf``.  Returns
    ``(f0, force, hammer)``, each one value per sample at ``target_sr``."""
    if plot:
        uplot.require("plot")
    d = os.path.join(root_dir, filename)
    x, sr = wavio.read(os.path.join(d, "input.wav"))
    if x.ndim > 1:
        x = x.mean(-1)
    if sr != target_sr:
        # a linear resample is enough for control extraction
        n_out = int(len(x) * target_sr / sr)
        x = np.interp(np.linspace(0, len(x) - 1, n_out), np.arange(len(x)), x)
        sr = target_sr

    # --- f0 track (string-f0.npy), unvoiced gaps filled from voiced ------
    f0, _ = track_f0(x, sr)
    t1 = np.arange(len(x)) / sr
    t2 = np.linspace(1 / sr, len(x) / sr, len(f0))
    f0_s = np.interp(t1, t2, np.where(f0 > 0, f0, np.nan))
    if np.isnan(f0_s).any():
        idx = np.arange(len(f0_s))
        good = ~np.isnan(f0_s)
        if good.any():
            f0_s = np.interp(idx, idx[good], f0_s[good])
        else:
            f0_s = np.full(len(f0_s), 110.0)
    np.save(os.path.join(d, "string-f0.npy"), f0_s)

    # --- bow force envelope (bow-F_b.npy) --------------------------------
    amp = get_amplitude(x)
    amp_s = np.interp(t1, np.linspace(1 / sr, len(x) / sr, len(amp)), amp)
    force = running_avg(amp_s)
    force = 100 * (force / 2 + 1e-5) ** 0.1
    force = np.where(force > 40, force, 0.0)
    np.save(os.path.join(d, "bow-F_b.npy"), force)

    # --- hammer strikes (hammer-v_H.npy) ---------------------------------
    hammer = onset_impulses(x, sr)
    np.save(os.path.join(d, "hammer-v_H.npy"), hammer)

    wavio.write(os.path.join(d, "sine-f0.wav"), sine_like(f0, len(x), sr) * 0.5, sr)
    if plot:
        uplot.rainbowgram(os.path.join(d, "spec.pdf"), x, sr, f0_input=f0)
    return f0_s, force, hammer


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m torch_fdtd_string_tpu_torch.tasks.preprocess_data "
                 "<root_dir> <name>")
    process(sys.argv[1], sys.argv[2], plot=False)
