"""Fundamental-frequency tracking on the host (numpy): two-stage YIN.

Port of ``torch_fdtd_string_tpu/utils/frequency.py``, which stands in for
the reference's CREPE tracker (``src/utils/analysis/frequency.py:4-9``):

1. classic YIN (exact truncated-window difference function, cumulative-mean
   normalisation, parabolic interpolation of the raw difference; de
   Cheveigné & Kawahara 2002 steps 1-5) for an octave-safe coarse period;
2. parabolic interpolation of the log-magnitude Hann spectrum around the
   peak nearest the YIN estimate, gated to ±3% of it.

``compute_harmonic_parameters(wav, sr)`` returns ``{"f0", "time"}`` with a
10 ms hop, as CREPE does.  The batched on-device twin is
``ops/postproc.py::yin_track``.
"""

from __future__ import annotations

import numpy as np

REFINE_PAD = 4  # zero-pad multiple AND half-width (bins) of the peak search


def _refine_spectral(fr, f0_est, sr):
    """Parabolic log-magnitude refinement of the spectral peak nearest each
    frame's f0 estimate.  fr: (F, n) frames; f0_est: (F,).  Returns (F,)."""
    F, n = fr.shape
    w = fr * np.hanning(n)[None, :]
    nfft = REFINE_PAD * n
    mag = np.abs(np.fft.rfft(w, nfft, axis=-1))
    k0 = np.round(np.clip(f0_est, 0.0, sr / 2) * nfft / sr).astype(int)
    k0 = np.clip(k0, 2, mag.shape[-1] - 3)
    rows = np.arange(F)
    span = np.arange(-REFINE_PAD, REFINE_PAD + 1)
    cand = np.clip(k0[:, None] + span[None, :], 1, mag.shape[-1] - 2)
    sub = mag[rows[:, None], cand]
    kpk = cand[rows, np.argmax(sub, axis=-1)]
    a = np.log(mag[rows, kpk - 1] + 1e-30)
    b = np.log(mag[rows, kpk] + 1e-30)
    c = np.log(mag[rows, kpk + 1] + 1e-30)
    den = a - 2.0 * b + c
    delta = np.where(den != 0, 0.5 * (a - c) / np.where(den == 0, 1.0, den),
                     0.0)
    delta = np.clip(delta, -0.5, 0.5)
    f_ref = (kpk + delta) * sr / nfft
    ok = (f0_est > 0) & (
        np.abs(f_ref - f0_est) < 0.03 * np.maximum(f0_est, 1e-9)
    )
    return np.where(ok, f_ref, f0_est)


def track_f0(wav, sr, hop_s=0.01, frame_s=0.064, fmin=32.0, fmax=2000.0,
             smooth=3, threshold=0.1, refine=True):
    """Frame-wise YIN track, vectorised over frames.  Returns
    ``(f0 (n_frames,), time (n_frames,))``."""
    wav = np.asarray(wav, np.float64)
    hop = int(sr * hop_s)
    frame = int(sr * frame_s)
    n_frames = max(1, len(wav) // hop + 1)
    pad = frame // 2
    x = np.pad(wav, (pad, pad + frame))

    idx = (np.arange(n_frames) * hop)[:, None] + np.arange(frame)[None, :]
    fr = x[idx]  # (F, n)
    silent = np.abs(fr).max(-1) < 1e-8

    tau_max = min(int(sr / fmin), frame - 1)
    tau_min = max(int(sr / fmax), 1)

    # exact truncated-window difference function, overlap-normalised:
    # d(tau) = (E[0..n-tau-1] + E[tau..n-1] - 2 acf(tau)) * n / (n - tau)
    n = frame
    w = fr - fr.mean(-1, keepdims=True)
    f = np.fft.rfft(w, 2 * frame, axis=-1)
    acf = np.fft.irfft(f * np.conj(f), axis=-1)[:, : tau_max + 1]
    ar = np.arange(tau_max + 1)
    E = np.add.accumulate(w**2, axis=-1)
    Etot = E[:, -1:]
    term1 = E[:, n - 1 - ar]
    term2 = Etot - np.concatenate([np.zeros_like(Etot), E[:, :tau_max]], -1)
    d = (term1 + term2 - 2.0 * acf) * (n / (n - ar))
    d[:, 0] = 0.0

    cum = np.add.accumulate(d[:, 1:], axis=-1)
    cmndf = np.concatenate(
        [np.ones_like(Etot), d[:, 1:] * ar[1:] / np.where(cum == 0, 1.0, cum)],
        axis=-1,
    )

    # first dip under the threshold, walked forward to its local minimum
    valid = (ar >= tau_min) & (ar < tau_max)
    below = (cmndf < threshold) & valid
    any_below = below.any(-1)
    first_t = np.argmax(below, axis=-1)
    cm_next = np.concatenate([cmndf[:, 1:], np.full_like(Etot, np.inf)], -1)
    dec = (cm_next < cmndf) & ((ar + 1) < tau_max)
    stop = (~dec) & (ar >= first_t[:, None])
    walk_t = np.argmax(stop, axis=-1)
    fallback = np.argmin(np.where(valid, cmndf, np.inf), axis=-1)
    tau_i = np.where(any_below, walk_t, fallback)

    # subharmonic guard: a dip at ~tau/2 about as deep means the chosen tau
    # is a period doubling
    rows = np.arange(n_frames)
    t2 = np.clip(tau_i // 2, 1, tau_max - 1)
    t2n = np.stack([t2 - 1, t2, t2 + 1], -1)
    t2 = t2 + np.argmin(cmndf[rows[:, None], t2n], -1) - 1
    take = (t2 >= tau_min) & (
        cmndf[rows, t2] < np.maximum(threshold, 1.15 * cmndf[rows, tau_i])
    )
    tau_i = np.where(take, t2, tau_i)

    # parabolic interpolation of the RAW difference function (step 5)
    a = d[rows, np.clip(tau_i - 1, 0, tau_max)]
    b = d[rows, tau_i]
    c = d[rows, np.clip(tau_i + 1, 0, tau_max)]
    denom = a - 2.0 * b + c
    inner = (tau_i >= 1) & (tau_i < tau_max) & (denom != 0)
    tau = tau_i + np.where(
        inner, 0.5 * (a - c) / np.where(denom == 0, 1.0, denom), 0.0
    )
    f0 = np.where(tau > 0, sr / np.where(tau > 0, tau, 1.0), 0.0)
    f0 = np.where(silent, 0.0, f0)

    if smooth > 1 and n_frames >= smooth:
        from scipy.signal import medfilt

        f0 = medfilt(f0, smooth if smooth % 2 else smooth + 1)
    if refine:
        f0 = _refine_spectral(fr, f0, sr)
    t = np.arange(n_frames) * hop_s
    return f0, t


def compute_harmonic_parameters(wav, sr):
    """CREPE-compatible entry point (reference frequency.py:4-9)."""
    f0, t = track_f0(wav, sr)
    return {"f0": f0, "time": t}
