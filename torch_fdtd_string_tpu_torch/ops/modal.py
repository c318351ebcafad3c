"""Modal additive synthesis.

Port of ``torch_fdtd_string_tpu/ops/modal.py``.  Only the host cosine bank
of the fused dataset path is ported; the device banks ``modal_synth``,
``harmonic_synth`` and ``modal_synth_nyquist`` wait for the DMSP slice and
the classic preprocessing path (ROADMAP Queue 1 items 8 and 9).
"""

from __future__ import annotations

import numpy as np


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
