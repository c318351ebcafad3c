"""Evaluation metric accumulators.

Port of ``torch_fdtd_string_tpu/models/objective.py`` (reference
``src/utils/objective.py``, torchmetrics): each metric keeps running
(sum, count) state with ``update``/``compute``/``reset`` semantics and the
``dist_reduce_fx="sum"`` combination as ``merge``.  Updates take numpy
arrays or tensors and accumulate host floats.
"""

from __future__ import annotations

import numpy as np
import torch

from .losses import MRSTFT, pde_loss, si_sdr


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Metric:
    """Running-mean metric: accumulate value sums and counts."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, *args, **kwargs):
        val, n = self._value(*args, **kwargs)
        self.total += float(val)
        self.count += int(n)

    def compute(self):
        return self.total / max(self.count, 1)

    def merge(self, other):
        """Combine accumulator state (the distributed sum reduction)."""
        self.total += other.total
        self.count += other.count
        return self


class MultiSpec(Metric):
    """Multi-resolution STFT distance (reference objective.py:269-286)."""

    def __init__(self, sr=48000, fft_sizes=(1024, 512, 256)):
        super().__init__()
        self.loss = MRSTFT(list(fft_sizes), [s // 4 for s in fft_sizes], list(fft_sizes),
                           w_log_mag=0.5, w_lin_mag=2.0, input_scale=1.0)

    def _value(self, preds, target):
        return float(self.loss(_t(preds), _t(target))) * len(preds), len(preds)


class SISDR(Metric):
    """(reference objective.py:289-303)."""

    def _value(self, preds, target):
        vals = si_sdr(_t(target), _t(preds))
        return float(vals.sum()), vals.numel()


class _MeanAbs(Metric):
    def _value(self, preds, target):
        d = np.abs(_np(preds) - _np(target))
        return d.mean() * d.shape[0], d.shape[0]


class ModeFreq(_MeanAbs):
    """L1 of predicted vs target mode frequencies (objective.py:307-320)."""


class ModeAmps(_MeanAbs):
    """L1 of predicted vs target mode amplitudes (objective.py:322-335)."""


class L1(_MeanAbs):
    pass


class MSE(Metric):
    def _value(self, preds, target):
        d = (_np(preds) - _np(target)) ** 2
        return d.mean() * d.shape[0], d.shape[0]


class PDELoss(Metric):
    """PDE-residual metric (reference objective.py:398-441): running mean of
    the IC/BC/interior-residual composite over predicted space-time fields."""

    def __init__(self, w_ic=1.0, w_bc=1.0, w_r=1.0):
        super().__init__()
        self.w = (w_ic, w_bc, w_r)

    def _value(self, pde_preds, u0, x, t, f0, kappa, sig0, sig1):
        pde_preds = _t(pde_preds)
        ut = pde_preds[..., 0] if pde_preds.dim() == 4 else pde_preds
        val = pde_loss(ut, _t(u0), _t(x), _t(t), _t(f0), _t(kappa), _t(sig0), _t(sig1),
                       w_ic=self.w[0], w_bc=self.w[1], w_r=self.w[2])
        return float(val) * ut.shape[0], ut.shape[0]


def build_metric_registry(sr=48000):
    """Metric registry keyed like reference synthesize.py:243-259: name ->
    (metric, the prediction-dict keys of its arguments)."""
    return {
        "mrstft": (MultiSpec(sr), ("preds", "target")),
        "sisdr": (SISDR(), ("preds", "target")),
        "modefreq": (ModeFreq(), ("preds_freq", "target_fk")),
        "modeamps": (ModeAmps(), ("preds_coef", "target_ck")),
        "mse": (MSE(), ("preds", "target")),
        "l1": (L1(), ("preds", "target")),
        "pde": (PDELoss(), ("pde_preds", "u_0", "xg", "tg", "f_0", "ka", "sig0", "sig1")),
    }
