"""DMSP task: model, batch preparation, losses, the train and eval steps
and the test scores.

Port of ``torch_fdtd_string_tpu/tasks/synthesize.py`` (reference
``src/task/synthesize.py``, the LightningModule): builds the
``Synthesizer``, prepares numpy batches (f0 frame downsampling,
mode-target trimming) and moves them to the model's device, computes the
configured multi-loss, takes a train step (autograd, then the optimizer of
``models/optim.py``), and scores the model and the analytic-modal baseline
per item in float64 on the device that holds the waveforms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.losses import si_sdr, stft_mag
from ..utils import misc as ms


@dataclass
class TrainState:
    """What a train step advances (JAX ``TrainState``): the model holds the
    parameters and constants, the optimizer its state and update count;
    ``step`` counts the steps taken, ``generator`` (on the model's device)
    draws the noise branch's samples, one draw per step, where the JAX
    package splits ``state.rng``."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def build_model(args, generator=None, device=None):
    """The configured ``Synthesizer``, its weights drawn from ``generator``,
    on ``device``."""
    from ..models.synthesizer import Synthesizer

    m = args.model
    model = Synthesizer(
        sr=args.task.sr,
        embed_dim=m.embed_dim,
        hidden_dim=m.hidden_dim,
        n_modes=m.n_modes,
        n_bands=m.n_bands,
        block_size=m.block_size,
        harmonic=m.harmonic,
        ddsp_fm=bool(m.get("ddsp_frequency_modulation") or False),
        mode_estimator=str(m.get("mode_estimator") or "mlp"),
        amp_adaptive_noise=bool(m.get("amp_adaptive_noise") or False),
        noise_floor=float(m.get("noise_floor") or 0.0),
        x_scale=tuple(m.x_scale),
        t_scale=tuple(m.t_scale),
        gamma_scale=tuple(m.gamma_scale),
        kappa_scale=tuple(m.kappa_scale),
        alpha_scale=tuple(m.alpha_scale),
        sig_0_scale=tuple(m.sig_0_scale),
        sig_1_scale=tuple(m.sig_1_scale),
        generator=generator,
    )
    return model.to(device) if device is not None else model


def prepare_batch(batch, n_modes, block_size, sr):
    """Numpy batch -> model inputs + loss targets (reference
    synthesize.py:288-320), numpy float32."""
    gt = batch["target"].astype(np.float32)  # (B, Nt)
    xg = batch["x"].astype(np.float32).reshape(-1, 1)
    tg = np.squeeze(batch["t"].astype(np.float32), -1)  # (B, Nt)
    ka = batch["kappa"].astype(np.float32).reshape(-1, 1)
    al = batch["alpha"].astype(np.float32).reshape(-1, 1)
    f_k = batch["mode_freq"].astype(np.float32)[:, :n_modes][:, None, :]
    c_k = batch["mode_coef"].astype(np.float32)[..., :n_modes].squeeze(1)
    f_0 = batch["f0"].astype(np.float32)
    u_0 = batch["u0"].astype(np.float32)
    t60 = batch["T60"].astype(np.float32)
    gt_f0 = batch["ut_f0"].astype(np.float32)

    f_0 = ms.downsample(f_0, factor=block_size).astype(np.float32)
    gt_f0 = (ms.downsample(gt_f0, size=f_0.shape[1]) / sr * (2 * math.pi)).astype(np.float32)
    extra = {}
    if "ua_f0" in batch:  # the modal baseline's pitch track (reference synthesize.py:407)
        an_f0 = batch["ua_f0"].astype(np.float32)
        extra["an_f0"] = (ms.downsample(an_f0, size=f_0.shape[1]) / sr
                          * (2 * math.pi)).astype(np.float32)
    if "gain" in batch:
        extra["gain"] = batch["gain"].astype(np.float32).reshape(-1, 1)
    return {
        **extra,
        "gt": gt, "xg": xg, "tg": tg, "ka": ka, "al": al, "t60": t60, "f_k": f_k,
        "c_k": c_k, "f_0": f_0, "u_0": u_0, "gt_f0": gt_f0,
        "analytic": batch.get("analytic", np.zeros_like(gt)).astype(np.float32),
    }


def to_device(prep, device):
    """A prepared batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in prep.items()}


def forward_outputs(model, prep, generator=None, inharmonic=True, use_gt_modes=True):
    """Model forward on a prepared batch of tensors -> the prediction dict
    of the loss registry.

    ``use_gt_modes`` mirrors the reference's mode-input protocol: training
    and the valid split feed the dataset's analytic mode tables
    (synthesize.py:306-307, 355-356); the test split synthesizes from the
    mode estimator's own modes unless ``model.use_precomputed_mode``
    (synthesize.py:409-410)."""
    gt_modes = inharmonic and use_gt_modes
    params_in = [prep["xg"], prep["tg"], prep["ka"], prep["al"], prep["t60"],
                 prep["f_k"] if gt_modes else None, prep["c_k"] if gt_modes else None]
    ut, (in_freq, in_coef), (ut_freq, ut_coef) = model(params_in, prep["f_0"], prep["u_0"],
                                                       generator)
    n = min(ut.shape[-1], prep["gt"].shape[-1])
    return {
        "preds": ut[..., :n],
        "target": prep["gt"][..., :n],
        "preds_f0": ut_freq[..., 0],
        "target_f0": prep["gt_f0"],
        "preds_fk": ut_freq[:, -1:, :],
        "target_fk": prep["f_k"],
        "preds_freq": in_freq,
        "preds_coef": in_coef,
        "target_ck": prep["c_k"],
    }


def compute_losses(outputs, registry, criteria):
    """Sum configured losses (reference synthesize.py:261-286)."""
    loss_dict = {}
    total = 0.0
    for name in criteria:
        fn, keys = registry[name]
        val = fn(*[outputs[k] for k in keys])
        loss_dict[name] = val
        total = total + val
    loss_dict["loss"] = total
    return total, loss_dict


def make_train_step(model, optimizer, registry, criteria, inharmonic=True, needs_value=False):
    """``train_step(state, prep) -> (state, loss_dict)``: the forward on
    the dataset's modes and the summed loss with autograd on, the backward,
    the optimizer's update (fed the loss when ``needs_value``: the plateau
    rule).  ``prep`` holds tensors on the model's device; the returned
    losses stay there (detached), so a step waits for nothing."""

    def train_step(state, prep):
        optimizer.zero_grad(set_to_none=True)
        outputs = forward_outputs(model, prep, state.generator, inharmonic)
        total, loss_dict = compute_losses(outputs, registry, criteria)
        total.backward()
        losses = {k: v.detach() for k, v in loss_dict.items()}
        optimizer.step(value=losses["loss"] if needs_value else None)
        state.step += 1
        return state, losses

    return train_step


def make_eval_step(model, registry, criteria, inharmonic=True, use_gt_modes=True):
    """``eval_step(prep, generator) -> (outputs, loss_dict)`` without
    gradients; ``prep`` holds tensors on the model's device."""

    @torch.no_grad()
    def eval_step(prep, generator=None):
        outputs = forward_outputs(model, prep, generator, inharmonic, use_gt_modes)
        _, loss_dict = compute_losses(outputs, registry, criteria)
        return outputs, loss_dict

    return eval_step


def _f64(x, device=None):
    """``x`` as a float64 tensor, on its own device (a tensor) or ``device``."""
    if torch.is_tensor(x):
        return x.detach().to(device or x.device, torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _wave_scores(preds, target):
    """si-sdr, sdr and log-mag L1 per item, float64 on the device of the
    tensor among the two (the host for two arrays); only the per-item rows
    come back to the host."""
    device = next((x.device for x in (preds, target) if torch.is_tensor(x)), None)
    preds, target = _f64(preds, device), _f64(target, device)
    sisdr = si_sdr(target, preds)
    sdr = si_sdr(target, preds, scaling=False)
    X = stft_mag(preds, 1024, 256)
    Y = stft_mag(target, 1024, 256)
    logmag = torch.abs(20 * torch.log10(X + 1e-5) - 20 * torch.log10(Y + 1e-5))
    return _host(sisdr), _host(sdr), _host(logmag.reshape(X.shape[0], -1).mean(-1))


def item_scores(preds, target, sr, target_f0_hz=None, preds_f0_rad=None):
    """Per-item test scores (reference synthesize.py:445-476): si-sdr, sdr,
    log-mag L1, f0 detune in Hz."""
    sisdr, sdr, logmag = _wave_scores(preds, target)
    out = {"si_sdr": sisdr, "sdr": sdr, "logmag": logmag}
    if target_f0_hz is not None and preds_f0_rad is not None:
        est_hz = _host(_f64(preds_f0_rad)) / (2 * np.pi) * sr
        target_f0_hz = np.asarray(target_f0_hz)
        n = min(est_hz.shape[-1], target_f0_hz.shape[-1])
        out["f0_hz"] = np.abs(est_hz[..., :n] - target_f0_hz[..., :n]).mean(-1)
    return out


def summarize_eval_scores(prep, preds, target, preds_f0_rad, target_f0_rad, sr):
    """Per-item test score row with the reference's full column set
    (synthesize.py:445-476 ``summarize_eval_scores``): string parameters
    (x_grid, kappa, alpha), pluck readouts (p_a, p_x), waveform scores
    (si_sdr, sdr, logmag, on the waveforms' device) and the f0 detune in
    Hz."""
    u0 = _host(prep["u_0"])[:, 0]  # (B, Nx)
    p_a = u0.max(-1)
    p_x = np.argmax(u0, axis=-1) / max(u0.shape[-1] - 1, 1)
    sisdr, sdr, logmag = _wave_scores(preds, target)
    est = _host(preds_f0_rad)
    tgt = _host(target_f0_rad)
    n = min(est.shape[-1], tgt.shape[-1])
    detune = np.abs(est[..., :n] - tgt[..., :n]).mean(-1) / (2 * math.pi) * sr
    return {
        "x_grid": _host(prep["xg"])[:, 0],
        "kappa": _host(prep["ka"])[:, 0],
        "alpha": _host(prep["al"])[:, 0],
        "p_a": p_a,
        "p_x": p_x,
        "si_sdr": sisdr,
        "sdr": sdr,
        "logmag": logmag,
        "f0_error": detune,
    }
