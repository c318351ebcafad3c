"""DDSP signal ops on tensors (counterpart of reference ``src/utils/ddsp.py``).

Port of ``torch_fdtd_string_tpu/ops/ddsp.py``: block-rate -> sample-rate
upsampling, sigmoid amplitude scaling, windowed-FIR noise shaping via FFT
convolution, and Nyquist masking.  The oscillator banks live in
``ops/modal.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def upsample(signal, factor):
    """Linear interpolation along axis 1 by an integer factor (reference
    ddsp.py:62-66): torch's non-aligned linear interpolation
    (``F.interpolate(mode="linear", align_corners=False)``), which the JAX
    package re-implements.  On a CUDA tensor it is computed by
    :func:`upsample_fixed_order`, since the CUDA backward of
    ``F.interpolate`` accumulates with atomics, in no fixed order; on the
    CPU, whose backward is a plain loop, by ``F.interpolate`` itself.

    signal: (B, T, C) -> (B, T*factor, C).
    """
    if signal.is_cuda:
        return upsample_fixed_order(signal, factor)
    out = F.interpolate(signal.transpose(1, 2), scale_factor=factor, mode="linear",
                        align_corners=False)
    return out.transpose(1, 2)


def upsample_fixed_order(signal, factor):
    """:func:`upsample` as weighted sums of the input and its edge-clamped
    one-step shifts, broadcast over the factor, so that its backward is a
    plain reduction.  Output sample ``r`` of frame ``t`` sits at
    ``t + off_r``, ``off_r = (r + 1/2) / factor - 1/2``: the first half of
    the factor between frames ``t - 1`` and ``t`` (frame 0 alone at the
    left edge, where torch clamps the source to 0), the second half
    between ``t`` and ``t + 1`` (the last frame twice at the right edge).
    It equals ``F.interpolate`` up to rounding (in float32 by up to one or
    two units in the last place, where torch's kernels fuse a product and
    a sum)."""
    if factor == 1:
        return signal
    B, T, C = signal.shape
    off = (torch.arange(factor, dtype=torch.float64) + 0.5) / factor - 0.5
    lo, hi = off[off < 0], off[off >= 0]
    # (T, r, 1) weights: below frame t, then above it
    w_prev = (-lo)[None, :].repeat(T, 1)
    w_prev[0] = 0.0
    w_lo = (1.0 + lo)[None, :].repeat(T, 1)
    w_lo[0] = 1.0
    w_hi, w_next = 1.0 - hi, hi

    def w(x):
        return x.to(signal.device, signal.dtype)[..., None]

    x = signal[:, :, None, :]  # (B, T, 1, C)
    x_prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    out = torch.cat([w(w_prev) * x_prev + w(w_lo) * x,
                     w(w_hi) * x + w(w_next) * x_next], dim=2)  # (B, T, factor, C)
    return out.reshape(B, T * factor, C)


def remove_above_nyquist(amplitudes, pitch, sampling_rate):
    """Mask harmonics above Nyquist (ddsp.py:70-77)."""
    n_harm = amplitudes.shape[-1]
    pitches = pitch * torch.arange(1, n_harm + 1, dtype=pitch.dtype, device=pitch.device)
    aa = (pitches < sampling_rate / 2).to(amplitudes.dtype) + 1e-4
    return amplitudes * aa


def remove_above_nyquist_mode(amplitudes, frequencies, sampling_rate):
    """Mask modes above Nyquist (ddsp.py:80-85)."""
    aa = (frequencies < sampling_rate / 2).to(amplitudes.dtype) + 1e-4
    return amplitudes * aa


def scale_function(x):
    """Sigmoid amplitude scaling to (0, 2) (ddsp.py:87-89)."""
    return 2 * torch.pow(torch.clamp(torch.sigmoid(x), 1e-7, 1.0), math.log(10)) + 1e-7


def amp_to_impulse_response(amp, target_size):
    """Zero-phase band amplitudes -> windowed FIR (ddsp.py:152-170): the
    inverse real FFT, centred by a roll, under a periodic Hann window, zero
    padded to ``target_size`` and rolled back."""
    cplx = torch.complex128 if amp.dtype == torch.float64 else torch.complex64
    ir = torch.fft.irfft(amp.to(cplx), dim=-1)
    filter_size = ir.shape[-1]
    ir = torch.roll(ir, filter_size // 2, dims=-1)
    win = torch.hann_window(filter_size, periodic=True, dtype=ir.dtype, device=ir.device)
    ir = F.pad(ir * win, (0, int(target_size) - filter_size))
    return torch.roll(ir, -filter_size // 2, dims=-1)


def fft_convolve(signal, kernel):
    """Linear convolution by FFT with centre trim (ddsp.py:173-177)."""
    n = signal.shape[-1]
    signal = F.pad(signal, (0, n))
    kernel = F.pad(kernel, (kernel.shape[-1], 0))
    out = torch.fft.irfft(torch.fft.rfft(signal) * torch.fft.rfft(kernel))
    return out[..., out.shape[-1] // 2:]
