"""Verification metrics (counterpart of reference ``src/utils/vnv.py``)."""

from __future__ import annotations

import numpy as np


def relative_detune_error(estimate, target):
    """Relative detune error in percent (reference vnv.py:3-8)."""
    estimate = np.asarray(estimate, np.float64)
    target = np.asarray(target, np.float64)
    return 100.0 * np.abs(estimate - target) / np.where(target == 0, 1.0, target)
