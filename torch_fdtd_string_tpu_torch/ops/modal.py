"""Modal additive synthesis.

Port of ``torch_fdtd_string_tpu/ops/modal.py``: the phase-accumulating
cosine and sine banks of the DMSP synthesizer (reference
``src/utils/ddsp.py:132-149``), evaluated as one running sum (in float64,
wrapped; :func:`phase_sum`) and a reduction over modes, and the
Nyquist-masked cosine bank of preprocessing (reference
``process_training_data.py:45-63``) on a device (:func:`modal_synth_nyquist`,
the classic path) and on the host (:func:`modal_synth_nyquist_np`, the
fused path's host build).
"""

from __future__ import annotations

import math

import numpy as np
import torch


SCAN_BLOCK = 128


def running_sum(x, dim=-2, block=SCAN_BLOCK):
    """The inclusive running sum of ``x`` along ``dim``, as
    ``torch.cumsum``, in a fixed order on every device: within blocks of
    ``block`` samples a product with a lower-triangular matrix of ones,
    then each block's total carried by a product with a strictly
    lower-triangular one.  CUDA's floating-point ``cumsum`` has no fixed
    order (it is refused under ``torch.use_deterministic_algorithms``), and
    neither has its backward; a product's forward and backward are
    matrix products, which repeat bit for bit."""
    x = x.movedim(dim, -2)
    n = x.shape[-2]
    bs = min(block, n)
    nb = -(-n // bs)
    pad = nb * bs - n
    xb = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    xb = xb.reshape(x.shape[:-2] + (nb, bs, x.shape[-1]))
    def ones(n):
        return torch.ones(n, n, dtype=x.dtype, device=x.device)

    inner = torch.tril(ones(bs)) @ xb  # (..., nb, bs, C)
    carry = torch.tril(ones(nb), diagonal=-1) @ inner[..., -1, :]  # (..., nb, C)
    out = (inner + carry[..., None, :]).reshape(x.shape[:-2] + (nb * bs, x.shape[-1]))
    return out[..., :n, :].movedim(-2, dim)


def phase_sum(freqs, dim=-2):
    """The running sum of per-sample phase increments along ``dim``
    (:func:`running_sum`), accumulated in float64; below float64 it is
    wrapped to [0, 2 pi) before it is rounded to the input's dtype.

    A float32 running sum over a one-second item reaches 1e5 rad, which
    float32 resolves only to ~8e-3 rad, and CUDA's cumsum accumulates
    float32 in float32: there the phase of 48,000 varying increments drifts
    by ~0.5 rad (the CPU's accumulates in float64).  Wrapped, the phase
    keeps ~5e-7 rad on every device.
    """
    phase = running_sum(freqs.to(torch.float64), dim=dim)
    if freqs.dtype == torch.float64:
        return phase
    return torch.remainder(phase, 2 * math.pi).to(freqs.dtype)


def modal_synth(freqs, coefs, damps):
    """Damped cosine bank.

    Args (broadcastable):
      freqs: (..., Nt, n_modes) per-sample angular increments [rad/sample].
      coefs: (..., Nt|1, n_modes) mode amplitudes.
      damps: (..., Nt, 1) damping envelope.
    Returns (..., Nt, 1): sum_n cos(cumsum_t freqs) * coefs * damps, the
    phase from :func:`phase_sum`.
    """
    return (torch.cos(phase_sum(freqs)) * coefs * damps).sum(-1, keepdim=True)


def harmonic_synth(f0, amplitudes, sr):
    """Sine bank at integer multiples of f0 (reference ddsp.py:132-137).

    f0: (..., Nt, 1) in Hz; amplitudes: (..., Nt, n_harm).  The
    fundamental's phase from :func:`phase_sum` (a wrapped phase times an
    integer is the same angle).
    """
    n_harm = amplitudes.shape[-1]
    omega = phase_sum(2 * math.pi * f0 / sr)
    omegas = omega * torch.arange(1, n_harm + 1, dtype=f0.dtype, device=f0.device)
    return (torch.sin(omegas) * amplitudes).sum(-1, keepdim=True)


def remove_above_nyquist_mode(amplitudes, frequencies_hz, sr):
    """Suppress modes above Nyquist (reference process_training_data.py:45-50)."""
    aa = (frequencies_hz < sr / 2).to(amplitudes.dtype) + 1e-4
    return amplitudes * aa


def modal_synth_nyquist_np(freq_tv, amps, damp, sr):
    """Nyquist-masked damped cosine bank on the host.

    freq_tv: (Nt, n) rad/sample; amps: (Nx, n); damp: (Nt,).  Returns
    (Nt, Nx) float32.  Phase accumulates in f64; modes above Nyquist keep
    1e-4 of their amplitude (reference process_training_data.py:45-63).
    """
    freq_tv = np.asarray(freq_tv, np.float64)
    hz = freq_tv / (2 * np.pi) * sr
    aa = (hz < sr / 2).astype(np.float32) + 1e-4
    phase = np.add.accumulate(freq_tv, axis=0)
    tbank = np.cos(phase).astype(np.float32) * aa
    tbank *= np.asarray(damp, np.float32)[:, None]
    return tbank @ np.ascontiguousarray(np.asarray(amps, np.float32).T)


def modal_synth_nyquist(freq_tv, amps, damp, sr):
    """Nyquist-masked damped cosine bank on the tensors' device.

    freq_tv: (1, Nt, n) rad/sample; amps: (Nx, 1, n); damp: (1, Nt, 1).
    Returns (Nx, Nt, 1) in ``amps``' dtype.  The phase is the float64
    running sum of ``freq_tv`` (:func:`phase_sum`), whatever its dtype;
    modes above Nyquist keep 1e-4 of their amplitude, and the modes are
    contracted as one (Nt, n) @ (n, Nx) product, so no (Nx, Nt, n) tensor
    is formed.  The arithmetic is :func:`modal_synth_nyquist_np`'s.
    """
    freq = freq_tv[0].to(torch.float64)  # (Nt, n)
    hz = freq / (2 * math.pi) * sr
    aa = (hz < sr / 2).to(amps.dtype) + 1e-4
    tbank = torch.cos(phase_sum(freq)).to(amps.dtype) * aa
    tbank = tbank * damp[0].to(amps.dtype)  # (Nt, n)
    out = tbank @ amps[:, 0, :].T  # (Nt, Nx)
    return out.T[:, :, None]
