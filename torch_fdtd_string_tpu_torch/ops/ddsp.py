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
    ddsp.py:62-66): torch's non-aligned linear interpolation, which the JAX
    package re-implements.

    signal: (B, T, C) -> (B, T*factor, C).
    """
    out = F.interpolate(signal.transpose(1, 2), scale_factor=factor, mode="linear",
                        align_corners=False)
    return out.transpose(1, 2)


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
