"""DMSP/DDSP synthesizer (``torch.nn``).

Port of ``torch_fdtd_string_tpu/models/synthesizer.py`` (reference
``src/model/nn/{synthesizer,dmsp,ddsp}.py``): *Differentiable Modal
Synthesis for Physical modeling*.  Physical string parameters condition FM
and AM modulation of an (in)harmonic oscillator bank plus a filtered-noise
branch; the model is trained to approximate the FDTD engine.

The noise branch draws its uniform samples through :func:`uniform`, from
the ``torch.Generator`` the caller passes to ``forward``, or as a rank's
rows of a global batch's draw (:class:`NoiseRows`).  The cores split
their forward into ``modulate`` (the FM/AM blocks), ``harmonic`` (the modal
bank) and ``noise``, and the synthesizer into ``condition`` (the mode
estimator and the conditioning features) and the core, so that each stage
can be timed on its own.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.ddsp import (amp_to_impulse_response, fft_convolve, remove_above_nyquist_mode,
                        scale_function, upsample)
from ..ops.modal import modal_synth
from .blocks import AMBlock, Dense, FMBlock, ModeEstimator, RFF
from .physmodes import PhysicsModeEstimator


def uniform(shape, generator, device, dtype):
    """The noise branch's uniform draw in [0, 1)."""
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


class NoiseRows:
    """The noise of a rank's ``rows`` (a slice) of a global batch of
    ``batch``: each draw is the whole batch's, from ``generator``, cut to
    the rows, so the rank's noise equals those rows of the single-card
    draw and every rank's generator advances alike."""

    def __init__(self, generator, rows, batch):
        self.generator, self.rows, self.batch = generator, rows, batch


def _noise(shape, generator, device, dtype):
    if isinstance(generator, NoiseRows):
        whole = uniform((generator.batch,) + tuple(shape[1:]), generator.generator, device,
                        dtype)
        return whole[generator.rows]
    return uniform(shape, generator, device, dtype)


def t60_to_sigma_frames(T60, f_0, K):
    """(b, frames, 2) sigma from per-frame f0 (reference audio.py:198-217).

    T60: (b, 2, 2); f_0: (b, frames, 1); K: (b, frames, 1).
    """
    gamma = 2.0 * f_0
    freq1, time1 = T60[:, None, 0, 0, None], T60[:, None, 0, 1, None]
    freq2, time2 = T60[:, None, 1, 0, None], T60[:, None, 1, 1, None]
    zeta1 = -(gamma**2) + torch.sqrt(gamma**4 + 4 * K**2 * (2 * math.pi * freq1) ** 2)
    zeta2 = -(gamma**2) + torch.sqrt(gamma**4 + 4 * K**2 * (2 * math.pi * freq2) ** 2)
    scale = 6 * math.log(10.0) / (zeta1 - zeta2)
    sig0 = scale * (-zeta2 / time1 + zeta1 / time2)
    sig1 = scale * (1.0 / time1 - 1.0 / time2)
    return torch.cat([sig0, sig1], dim=-1)


class _Core(nn.Module):
    """What the two cores share: the FM/AM blocks' output masked above
    Nyquist, the modal bank, and the filtered noise."""

    block_size: int
    sr: int

    def harmonic(self, freq_m, coef_m, lengths):
        """The modal bank at the sample rate: (b, lengths, 1)."""
        freq_s = upsample(freq_m, self.block_size)[:, :lengths]
        coef_s = upsample(coef_m, self.block_size)[:, :lengths]
        return modal_synth(freq_s, coef_s, torch.ones_like(freq_s[..., :1]))

    def _mask(self, freq_m, coef_m):
        freqs_hz = freq_m / (2 * math.pi) * self.sr
        return remove_above_nyquist_mode(coef_m, freqs_hz, self.sr)

    def _filtered_noise(self, param, lengths, generator):
        impulse = amp_to_impulse_response(param, self.block_size)
        shape = tuple(impulse.shape[:2]) + (self.block_size,)
        noise = _noise(shape, generator, param.device, param.dtype) * 2.0 - 1.0
        noise = fft_convolve(noise, impulse)
        return noise.reshape(noise.shape[0], -1, 1)[:, :lengths]

    def forward(self, hidden, mode_freq, mode_coef, times, alpha, omega, lengths,
                generator):
        freq_m, coef_m = self.modulate(hidden, mode_freq, mode_coef, times, alpha, omega)
        harmonic = self.harmonic(freq_m, coef_m, lengths)
        noise = self.noise(hidden, coef_m, alpha, lengths, generator)
        return (harmonic + noise)[..., 0], freq_m, coef_m


class DMSPCore(_Core):
    """Inharmonic modal core (reference dmsp.py).

    ``amp_adaptive_noise`` scales the noise filter by the per-frame modal
    amplitude envelope (reference parity: off, where the noise level is a
    function of the conditioning features only); the level is then
    ``(noise_floor + 50 s env)`` times the parity level, ``s`` a learned
    gain.
    """

    def __init__(self, embed_dim, hidden_size, n_features, n_modes, n_bands, block_size,
                 sr, feature_dim, amp_adaptive_noise=False, noise_floor=0.0,
                 generator=None):
        super().__init__()
        self.block_size, self.sr = block_size, sr
        self.amp_adaptive_noise, self.noise_floor = amp_adaptive_noise, noise_floor
        self.fm = FMBlock(n_modes, embed_dim, n_features, feature_dim, generator)
        self.am = AMBlock(n_modes, embed_dim, n_features, feature_dim, generator)
        self.noise_dense = Dense(feature_dim, n_bands, generator)
        if amp_adaptive_noise:
            self.noise_env_gain = nn.Parameter(torch.tensor(1.0))

    def modulate(self, hidden, mode_freq, mode_coef, times, alpha, omega):
        freq_m = self.fm(mode_freq, hidden, alpha, omega)
        coef_m = self.am(mode_coef, hidden, times)
        return freq_m, self._mask(freq_m, coef_m)

    def noise(self, hidden, coef_m, alpha, lengths, generator):
        param = scale_function(self.noise_dense(hidden) - 5.0)
        if self.amp_adaptive_noise:
            # eps under the sqrt: nyquist-masked frames can zero the mean;
            # detached, the envelope is pure conditioning
            env = torch.sqrt(torch.mean(coef_m**2, dim=-1, keepdim=True) + 1e-12).detach()
            param = param * (self.noise_floor + 50.0 * self.noise_env_gain * env)
        return self._filtered_noise(param, lengths, generator)


class DDSPCore(_Core):
    """Harmonic (integer-multiple) core with alpha-gated noise (reference
    ddsp.py)."""

    def __init__(self, feature_size, hidden_size, n_modes, n_bands, block_size, sr,
                 fm=False, embed_dim=64, n_features=7, generator=None):
        super().__init__()
        self.block_size, self.sr = block_size, sr
        self.fm = (FMBlock(n_modes, embed_dim, n_features, feature_size, generator)
                   if fm else None)
        self.am = AMBlock(n_modes, embed_dim, n_features, feature_size, generator)
        self.noise_gate = nn.Parameter(torch.tensor([1e-2]))
        self.noise_dense = Dense(feature_size, n_bands, generator)

    def modulate(self, hidden, mode_freq, mode_coef, times, alpha, omega):
        freq_m = mode_freq if self.fm is None else self.fm(mode_freq, hidden, alpha, omega)
        coef_m = self.am(mode_coef, hidden, times)
        return freq_m, self._mask(freq_m, coef_m)

    def noise(self, hidden, coef_m, alpha, lengths, generator):
        ngate = torch.tanh((alpha - 1.0) * self.noise_gate)
        param = ngate * torch.sigmoid(self.noise_dense(hidden) - 5.0)
        return self._filtered_noise(param, lengths, generator)


class Synthesizer(nn.Module):
    """Top-level parameter -> waveform synthesizer (reference
    synthesizer.py:9-125).

    ``mode_estimator``: ``"mlp"``, the reference's learned estimator
    (``blocks.ModeEstimator``), or ``"physics"``, the embedded dispersion
    tables and amplitude fit (``models/physmodes.py``), with no learned
    parameters.
    """

    N_FEATS = 7

    def __init__(self, sr=48000, embed_dim=128, hidden_dim=512, n_modes=40, n_bands=65,
                 block_size=256, harmonic="inharmonic", ddsp_fm=False,
                 mode_estimator="mlp", amp_adaptive_noise=False, noise_floor=0.0,
                 x_scale: Sequence[float] = (0.0, 1.0),
                 t_scale: Sequence[float] = (0.0, 0.3),
                 gamma_scale: Sequence[float] = (196.0, 880.0),
                 kappa_scale: Sequence[float] = (0.01, 0.03),
                 alpha_scale: Sequence[float] = (1.0, 30.0),
                 sig_0_scale: Sequence[float] = (0.0, 0.7),
                 sig_1_scale: Sequence[float] = (0.0, 1e-5), generator=None):
        super().__init__()
        self.sr, self.n_modes, self.block_size = sr, n_modes, block_size
        self.inharmonic = harmonic.lower() == "inharmonic"
        self.mode_estimator = mode_estimator
        self.scales = dict(x=x_scale, t=t_scale, gamma=gamma_scale, kappa=kappa_scale,
                           alpha=alpha_scale, sig_0=sig_0_scale, sig_1=sig_1_scale)
        if mode_estimator == "physics":
            self.estimator = PhysicsModeEstimator(n_modes, tuple(kappa_scale), sr=sr)
        else:
            # the reference sizes the learned estimator by embed_dim
            self.estimator = ModeEstimator(n_modes, embed_dim, kappa_scale, gamma_scale,
                                           inharmonic=self.inharmonic, sr=sr,
                                           generator=generator)
        self.rff = RFF([1.0] * self.N_FEATS, embed_dim // 2)
        if self.inharmonic:
            self.core = DMSPCore(embed_dim, hidden_dim, self.N_FEATS, n_modes, n_bands,
                                 block_size, sr, self.rff.out_dim,
                                 amp_adaptive_noise=amp_adaptive_noise,
                                 noise_floor=noise_floor, generator=generator)
        else:
            self.core = DDSPCore(self.rff.out_dim, hidden_dim, n_modes, n_bands,
                                 block_size, sr, fm=ddsp_fm, embed_dim=embed_dim,
                                 n_features=self.N_FEATS, generator=generator)

    def _rescale(self, var, name):
        scale = self.scales[name]
        lo = min(scale)
        return (var - lo) / (max(scale) - lo)

    def condition(self, params, pitch, initial):
        """The mode estimator and the conditioning features: the core's
        inputs ``(hidden, mode_freq, mode_coef, times, alpha, omega,
        lengths)`` and the estimator's ``(in_freq, in_coef)``.

        params = [space, times, kappa, alpha, t60, mode_freq, mode_coef]
        (mode_freq/coef may be None -> use the mode estimator);
        pitch: (b, frames); initial: (b, 1, Nx).
        """
        space, times, kappa, alpha, t60, mode_freq, mode_coef = params
        f_0 = pitch[..., None]  # (b, frames, 1)
        times = times[..., None]  # (b, Nt, 1)
        kappa, alpha, space = kappa[..., None], alpha[..., None], space[..., None]
        gamma = 2.0 * f_0
        omega = f_0 / self.sr * (2 * math.pi)
        relf0 = omega - omega[:, :1]

        if self.mode_estimator == "physics":
            # frame 0, not the reference's frame 9: the dataset mode tables
            # are built at onset omega_0 and the linear FM below is relative
            # to frame 0, so the exact computation belongs at frame 0 too
            in_coef, in_freq = self.estimator(initial, space, kappa, gamma[:, :1], t60)
        else:
            # the reference conditions on the 10th f0 frame
            # (synthesizer.py:77); clamped for short clips
            gi = min(9, gamma.shape[1] - 1)
            in_coef, in_freq = self.estimator(initial, space, kappa, gamma[:, gi:gi + 1])
        mode_coef = in_coef if mode_coef is None else mode_coef
        mode_freq = in_freq if mode_freq is None else mode_freq
        mode_freq = mode_freq + relf0  # linear FM

        Nt, Nf = times.shape[1], mode_freq.shape[1]
        b = space.shape[0]
        # the running count of frames (JAX: cumsum of ones), exact as an arange
        count = torch.arange(1, Nf + 1, dtype=times.dtype, device=times.device)
        frames = count[None, :, None] / self.sr + times[:, :1]

        n_frames = f_0.shape[1]
        space_f = space.expand(b, n_frames, 1)
        alpha_f = alpha.expand(b, n_frames, 1)
        kappa_f = kappa.expand(b, n_frames, 1)
        sig_0, sig_1 = t60_to_sigma_frames(t60, f_0, 2 * f_0 * kappa_f).chunk(2, dim=-1)
        feat = torch.cat([
            self._rescale(space_f, "x"),
            self._rescale(frames - max(self.scales["t"]), "t"),
            self._rescale(kappa_f, "kappa"),
            self._rescale(alpha_f, "alpha"),
            self._rescale(sig_0, "sig_0"),
            self._rescale(sig_1, "sig_1"),
            self._rescale(gamma, "gamma"),
        ], dim=-1)
        hidden = self.rff(feat)
        mode_coef = mode_coef * torch.exp(-frames * sig_0)  # damping
        return (hidden, mode_freq, mode_coef, frames, alpha_f, omega, Nt), (in_freq, in_coef)

    def forward(self, params, pitch, initial, generator=None):
        """Returns ``ut (b, Nt), (in_freq, in_coef), (ut_freq, ut_coef)``;
        the noise is drawn from ``generator``."""
        core_in, est = self.condition(params, pitch, initial)
        ut, ut_freq, ut_coef = self.core(*core_in, generator)
        return ut, est, (ut_freq, ut_coef)
