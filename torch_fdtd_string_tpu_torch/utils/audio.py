"""Audio utilities (numpy host side).

Re-implementations of the pieces of the reference ``src/utils/audio.py`` the
pipeline uses: normalisation, silence metering, state-to-wav reduction, mel
filter bank and STFT helpers (librosa-free), and the T60->sigma conversion.
"""

from __future__ import annotations

import numpy as np


def ell_infty_normalize(x, normalize_dims=1):
    """Normalise to unit max-abs (audio.py:58-70). Returns (x_norm, gain).

    For inputs with ndim <= normalize_dims the whole array is normalised by
    a scalar gain (1-D waveforms).
    """
    x = np.asarray(x)
    eps = np.finfo(x.dtype).eps if np.issubdtype(x.dtype, np.floating) else 1e-12
    if x.ndim <= normalize_dims:
        gain = 1.0 / (np.abs(x).max() + eps)
        return x * gain, gain
    flat = x.reshape(x.shape[:normalize_dims] + (-1,))
    x_max = np.abs(flat).max(axis=-1) + eps
    shape = x.shape[:normalize_dims] + (1,) * (x.ndim - normalize_dims)
    gain = 1.0 / x_max.reshape(shape)
    return x * gain, gain


def rms_normalize(x, ref_dBFS=-23.0):
    """RMS-normalise to a reference level (audio.py:25-43)."""
    x = np.asarray(x)
    eps = np.finfo(np.float64).eps
    rms = np.sqrt(np.mean(x**2, axis=-1, keepdims=True))
    ref_linear = 10 ** (ref_dBFS / 20.0)
    gain = ref_linear / (rms + eps)
    return x * gain, gain


def dB_RMS(x, axis=-1):
    """RMS level in dB (audio.py:72-76)."""
    x = np.asarray(x, np.float64)
    eps = np.finfo(np.float64).eps
    return 20 * np.log10(np.sqrt(np.mean(x**2, axis=axis)) + eps)


def state_to_wav(states, k=1.0):
    """Sum the spatial axis of a velocity field (audio.py:108-113).

    states: (..., Nt, Nx) displacement; returns (..., Nt-1) waveform of the
    summed finite-difference velocity.
    """
    states = np.asarray(states)
    vel = (states[..., 1:, :] - states[..., :-1, :]) / k
    return vel.sum(-1)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-style mel filter bank (librosa-compatible shapes)."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + 27.0 * np.log(np.maximum(f, 1e-9) / 1000.0) / np.log(6.4), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    enorm = 2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels])
    return fb * enorm[:, None]


def stft_mag(x, n_fft=1024, hop=256, window=None):
    """Magnitude STFT, center-padded (numpy)."""
    x = np.asarray(x, np.float64)
    if window is None:
        window = np.hanning(n_fft)
    pad = n_fft // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[..., idx] * window
    return np.abs(np.fft.rfft(frames, axis=-1))


def T60_to_sigma(T60, gamma, K):
    """Numpy twin of ops.fdm.t60_to_sigma (reference audio.py:198-217)."""
    T60 = np.asarray(T60, np.float64)
    gamma = np.asarray(gamma, np.float64)
    K = np.asarray(K, np.float64)
    freq1, time1 = T60[..., 0, 0], T60[..., 0, 1]
    freq2, time2 = T60[..., 1, 0], T60[..., 1, 1]
    stiff = K > 0
    g2 = np.where(gamma != 0, gamma, 1.0) ** 2
    zeta1 = np.where(
        stiff,
        -(gamma**2) + np.sqrt(gamma**4 + 4 * K**2 * (2 * np.pi * freq1) ** 2),
        freq1**2 / g2,
    )
    zeta2 = np.where(
        stiff,
        -(gamma**2) + np.sqrt(gamma**4 + 4 * K**2 * (2 * np.pi * freq2) ** 2),
        freq2**2 / g2,
    )
    lossy = (T60.prod(-1).prod(-1)) != 0
    t1 = np.where(time1 != 0, time1, 1.0)
    t2 = np.where(time2 != 0, time2, 1.0)
    sig0 = np.where(lossy, -zeta2 / t1 + zeta1 / t2, lossy.astype(np.float64))
    sig1 = np.where(lossy, 1.0 / t1 - 1.0 / t2, lossy.astype(np.float64))
    scale = 6 * np.log(10) / (zeta1 - zeta2)
    return scale * sig0, scale * sig1
