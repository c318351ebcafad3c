"""Training losses on tensors, counterpart of reference ``src/utils/loss.py``.

Port of ``torch_fdtd_string_tpu/models/losses.py``.  The registry keyed by
``task.loss_criteria`` mirrors reference ``synthesize.py:135-148``: l1
(scale-invariant), f0, fk, sisdr, fft, magspec/melspec (multi-resolution
STFT), modefreq, modeamps, and the PDE scaffolding (bc, ic, pde_loss).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from ..utils.audio import mel_filterbank


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


def stft_mag(x, n_fft, hop):
    """Magnitude STFT with reflect centre padding by ``n_fft // 2`` and a
    periodic Hann window.  x: (..., n) -> (..., frames, n_fft//2+1)."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = xp[:, 0].unfold(-1, n_fft, hop)  # (N, frames, n_fft)
    win = torch.hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    mag = torch.abs(torch.fft.rfft(frames * win, dim=-1))
    return mag.reshape(lead + mag.shape[-2:])


def si_sdr(reference, estimate, eps=1e-8, scaling=True):
    """Scale-invariant SDR (reference loss.py:85-107). Last axis = time."""
    if scaling:
        num = torch.sum(reference * estimate, dim=-1, keepdim=True) + eps
        den = torch.sum(reference**2, dim=-1, keepdim=True) + eps
        a = num / den
    else:
        a = 1.0
    e_true = a * reference
    e_res = estimate - e_true
    Sss = torch.sum(e_true**2, dim=-1) + eps
    Snn = torch.sum(e_res**2, dim=-1) + eps
    return 10 * torch.log10(Sss / Snn)


def l1_loss(preds, target, scale_invariance=True, weight=1.0):
    """(Reference loss.py:161-175.)"""
    if scale_invariance:
        eps = torch.finfo(target.dtype).eps
        eps = target.new_tensor(eps)  # jnp.maximum's gradient at a tie
        p_rms = torch.sqrt(torch.maximum(torch.mean(preds**2, -1, keepdim=True), eps))
        t_rms = torch.sqrt(torch.maximum(torch.mean(target**2, -1, keepdim=True), eps))
        preds = preds / p_rms
        target = target / t_rms
    return weight * _l1(preds, target)


def f0_loss(preds_f0, target_f0, scale=1.0, weight=10.0):
    """Normalised f0 L1 (loss.py:268-286).

    Normalisation uses the within-batch mean/std of the target track
    (reference parity), so the value depends on batch composition; the
    Hz-denominated ``f0_error`` of the score tables does not.
    """
    mean = torch.mean(target_f0)
    std = torch.std(target_f0 - mean, correction=0) + 1e-12
    p = (preds_f0 - mean) / std * scale
    t = (target_f0 - mean) / std * scale
    return weight * _l1(p, t)


def fk_loss(preds_fk, target_fk, scale=1.0, weight=1.0):
    """Mode-index-decaying weighted L1 (loss.py:119-132)."""
    n = target_fk.shape[-1]
    w = scale * torch.arange(n, 0, -1, dtype=target_fk.dtype, device=target_fk.device) / n
    return weight * _l1(w * preds_fk, w * target_fk)


def mode_freq_loss(preds_freq, target_fk, scale=1.0, weight=1.0):
    return weight * _l1(scale * preds_freq, scale * target_fk)


def mode_amps_loss(preds_coef, target_ck, scale=200.0, weight=20.0):
    return weight * _l1(scale * preds_coef, scale * target_ck)


def sisdr_loss(preds, target):
    """(loss.py:177-187)."""
    return -torch.mean(si_sdr(target, preds)) / 20.0


def fft_loss(preds, target, weight=10.0):
    """L1 over the complex rfft (loss.py:189-197): mean |diff|."""
    d = torch.fft.rfft(preds) - torch.fft.rfft(target)
    return weight * torch.mean(torch.abs(d))


def mse_loss(preds, target):
    return torch.mean((preds - target) ** 2)


class MRSTFT:
    """Multi-resolution STFT loss (auraloss-equivalent; loss.py:199-217):
    the mean over resolutions of ``w_lin`` times the L1 of the magnitudes
    plus ``w_log`` times the L1 of their logs, on linear or mel bins."""

    def __init__(self, fft_sizes, hop_sizes, win_lengths, w_log_mag=0.5,
                 w_lin_mag=2.0, input_scale=10.0, weight=1.0, scale=None,
                 n_bins=128, sample_rate=48000):
        self.res = list(zip(fft_sizes, hop_sizes, win_lengths))
        self.w_log = w_log_mag
        self.w_lin = w_lin_mag
        self.input_scale = input_scale
        self.weight = weight
        self.mel = None
        if scale == "mel":
            self.mel = [torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_bins),
                                        dtype=torch.float32)
                        for (n_fft, _, _) in self.res]

    def __call__(self, preds, target):
        preds = preds * self.input_scale
        target = target * self.input_scale
        total = 0.0
        for i, (n_fft, hop, _) in enumerate(self.res):
            X = stft_mag(preds, n_fft, hop)
            Y = stft_mag(target, n_fft, hop)
            if self.mel is not None:
                mel = self.mel[i].to(X.device, X.dtype)
                X = X @ mel.T
                Y = Y @ mel.T
            lin = _l1(X, Y)
            log = _l1(torch.log(X + 1e-7), torch.log(Y + 1e-7))
            total = total + self.w_lin * lin + self.w_log * log
        return self.weight * total / len(self.res)


def dirichlet_bc(u):
    """Mean |u| at the two boundary columns (reference loss.py:57-60).

    u: (B, Nt, Nx)."""
    return 0.5 * (torch.mean(torch.abs(u[..., 0])) + torch.mean(torch.abs(u[..., -1])))


def bc_loss(preds_bc, weight=1.0):
    """BCLoss twin (reference loss.py:249-257): L1 of boundary samples
    against zero."""
    return weight * torch.mean(torch.abs(preds_bc))


def ic_loss(preds_ic, target_ic, weight=1.0):
    """ICLoss twin (reference loss.py:259-266)."""
    return weight * torch.mean(torch.abs(preds_ic - target_ic))


def fdtd_residual(ut, x, t, f0, kappa, sig0, sig1):
    """Default interior-residual hook for :func:`pde_loss`: the centered
    second-order residual of the linear lossy stiff-string PDE

        u_tt + 2 sig0 u_t - gamma^2 u_xx + K^2 u_xxxx - 2 sig1 u_txx = 0

    on the predicted space-time field.

    ut: (B, Nt, Nx); x: (B, 1, Nx) or (Nx,); t: (B, Nt, 1) or (Nt,).
    """
    x = torch.as_tensor(x, dtype=ut.dtype, device=ut.device)
    t = torch.as_tensor(t, dtype=ut.dtype, device=ut.device)
    x = x.reshape(ut.shape[0], 1, -1) if x.dim() > 1 else x.reshape(1, 1, -1)
    t = t.reshape(ut.shape[0], -1, 1) if t.dim() > 1 else t.reshape(1, -1, 1)
    dx = x[:, :, 1:2] - x[:, :, 0:1]
    dt_ = t[:, 1:2] - t[:, 0:1]
    col = lambda v: torch.as_tensor(v, dtype=ut.dtype, device=ut.device).reshape(-1, 1, 1)
    gamma = col(2.0 * torch.as_tensor(f0))
    K = col(kappa) * gamma
    s0, s1 = col(sig0), col(sig1)
    u_t = (ut[:, 2:, :] - ut[:, :-2, :]) / (2.0 * dt_)
    u_tt = (ut[:, 2:, :] - 2.0 * ut[:, 1:-1, :] + ut[:, :-2, :]) / dt_**2
    uc = ut[:, 1:-1, :]
    u_xx = (uc[:, :, 2:] - 2.0 * uc[:, :, 1:-1] + uc[:, :, :-2]) / dx**2
    u4 = (uc[:, :, 4:] - 4.0 * uc[:, :, 3:-1] + 6.0 * uc[:, :, 2:-2]
          - 4.0 * uc[:, :, 1:-3] + uc[:, :, :-4]) / dx**4
    ut_xx = (u_t[:, :, 2:] - 2.0 * u_t[:, :, 1:-1] + u_t[:, :, :-2]) / dx**2
    r = (u_tt[:, :, 2:-2] + 2.0 * s0 * u_t[:, :, 2:-2]
         - gamma**2 * u_xx[:, :, 1:-1] + K**2 * u4
         - 2.0 * s1 * ut_xx[:, :, 1:-1])
    return torch.mean(r**2)


def pde_loss(ut, u0, x, t, f0, kappa, sig0, sig1,
             f_ic=None, f_bc=None, f_r=None, w_ic=1.0, w_bc=1.0, w_r=1.0):
    """PDELoss twin (reference loss.py:62-83, 219-247): weighted sum of
    initial-condition, boundary-condition and interior-residual terms over
    a predicted space-time field ``ut`` (B, Nt, Nx)."""
    f_ic = f_ic or ic_loss
    f_bc = f_bc or dirichlet_bc
    f_r = f_r or fdtd_residual
    u0 = torch.as_tensor(u0, dtype=ut.dtype, device=ut.device)
    val_ic = f_ic(ut[:, 0, :], u0.reshape(ut[:, 0, :].shape))
    val_bc = f_bc(ut)
    val_r = f_r(ut, x, t, f0, kappa, sig0, sig1)
    return w_ic * val_ic + w_bc * val_bc + w_r * val_r


def build_loss_registry(sr, Nt):
    """Loss registry keyed like reference synthesize.py:135-148: name ->
    (function, the prediction-dict keys of its arguments)."""
    size_1 = min(Nt, 1024)
    size_2 = 2 ** int(math.log2(size_1) - 1)
    size_3 = 2 ** int(math.log2(size_1) - 2)
    magspec = MRSTFT([size_1, size_2, size_3], [size_1 // 4, size_2 // 4, size_3 // 4],
                     [size_1, size_2, size_3], w_log_mag=0.5, w_lin_mag=2.0,
                     input_scale=10.0)
    melspec = MRSTFT([size_1], [size_1 // 4], [size_1], w_log_mag=0.5, w_lin_mag=2.0,
                     input_scale=10.0, scale="mel", n_bins=128, sample_rate=sr)
    return {
        "l1": (partial(l1_loss, scale_invariance=True), ("preds", "target")),
        "mse": (mse_loss, ("preds", "target")),
        "f0": (partial(f0_loss, scale=1.0, weight=10.0), ("preds_f0", "target_f0")),
        "fk": (partial(fk_loss, scale=1.0, weight=1.0), ("preds_fk", "target_fk")),
        "sisdr": (sisdr_loss, ("preds", "target")),
        "fft": (partial(fft_loss, weight=10.0), ("preds", "target")),
        "magspec": (magspec, ("preds", "target")),
        "melspec": (melspec, ("preds", "target")),
        "mrstft": (magspec, ("preds", "target")),
        "modefreq": (partial(mode_freq_loss, scale=1.0, weight=1.0),
                     ("preds_freq", "target_fk")),
        "modeamps": (partial(mode_amps_loss, scale=200.0, weight=20.0),
                     ("preds_coef", "target_ck")),
        # PDE scaffolding (reference loss.py:219-266; in no default criteria)
        "bc": (bc_loss, ("preds_bc",)),
        "ic": (ic_loss, ("preds_ic", "target_ic")),
    }
