"""Neural building blocks (``torch.nn``).

Port of ``torch_fdtd_string_tpu/models/blocks.py`` (reference
``src/model/nn/blocks.py``): random-Fourier-feature embeddings with
learnable log-scales, GLU-gated modulation MLPs for mode
frequencies/amplitudes, and the mode estimator that maps physical string
parameters to (amplitudes, monotone frequencies).

Every module is built from an explicit ``torch.Generator`` and initialised
as flax initialises the JAX package's: ``Dense`` kernels lecun-normal (a
normal truncated at two deviations), biases zero, the constants from the
same numpy seeds.  ``models/convert.py`` carries the JAX package's
variables into these modules.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.modal import running_sum

# the deviation of a unit normal truncated to [-2, 2], by which flax's
# variance_scaling divides the deviation it asks for
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``flax.linen.Dense``: lecun-normal kernel, zero bias, drawn from
    ``generator``.  ``weight`` is the flax kernel transposed."""

    def __init__(self, in_features, out_features, generator):
        super().__init__(in_features, out_features)
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            self.bias.zero_()

    def reset_parameters(self):
        """The draw is ``__init__``'s, from the caller's generator."""


def fourier_feature(x, B):
    """sin/cos projection features (reference misc.py:225-233)."""
    if B is None:
        return x
    proj = (2.0 * math.pi * x) @ B
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class MLP(nn.Module):
    """n_layers x [Dense -> PReLU] (reference blocks.py:121-128), one PReLU
    slope per layer."""

    def __init__(self, in_dim, hidden, n_layers, generator):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(in_dim if i == 0 else hidden, hidden, generator) for i in range(n_layers))
        self.prelu = nn.Parameter(torch.full((n_layers,), 0.25))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            # maximum / minimum, not clamp: at x == 0 they split the
            # gradient as jnp.maximum / jnp.minimum do
            zero = x.new_zeros(())
            x = torch.maximum(x, zero) + self.prelu[i] * torch.minimum(x, zero)
        return x


class RFF(nn.Module):
    """Per-feature RFF with learnable log10 scales (blocks.py:148-169).

    Input (..., n_feats) -> (..., n_feats * 2*embed_half).  ``N`` is a
    constant from ``np.random.default_rng(0)``, as in the JAX package.
    """

    def __init__(self, scales: Sequence[float], embed_half):
        super().__init__()
        n_feats = len(scales)
        self.register_buffer("N", torch.as_tensor(
            np.random.default_rng(0).standard_normal((n_feats, embed_half)),
            dtype=torch.float32))
        self.e = nn.Parameter(torch.tensor(list(scales), dtype=torch.float32).reshape(-1, 1))

    @property
    def out_dim(self):
        return self.N.numel() * 2

    def forward(self, x):
        B = torch.pow(10.0, self.e) * self.N  # (n_feats, embed_half)
        proj = (2.0 * math.pi * x)[..., None] * B
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1).flatten(-2)


class RFF2(nn.Module):
    """Dense RFF with a single learnable scale (blocks.py:130-146).

    Input (..., input_dim) -> (..., 2*embed_half).
    """

    def __init__(self, input_dim, embed_half):
        super().__init__()
        self.input_dim, self.embed_half = input_dim, embed_half
        self.e = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        N = torch.ones((self.input_dim, self.embed_half), dtype=x.dtype, device=x.device) / (
            self.input_dim * self.embed_half)
        return fourier_feature(x, self.e * N)


def apply_gain(x, gain, n_chunks):
    """Per-chunk feature gain (blocks.py:36-40) with tanh squashing."""
    g = torch.tanh(gain)
    chunks = x.reshape(x.shape[:-1] + (n_chunks, -1))
    return (chunks * g[:, None]).reshape(x.shape)


def _gain_in(seed, n):
    return nn.Parameter(0.5 * torch.as_tensor(
        np.random.default_rng(seed).standard_normal((n,)), dtype=torch.float32))


class FMBlock(nn.Module):
    """Frequency modulation block (blocks.py:42-71)."""

    def __init__(self, input_dim, embed_dim, num_features, feature_dim, generator):
        super().__init__()
        self.num_features = num_features
        self.rff2 = RFF2(input_dim, embed_dim // 2)
        e2 = 2 * (embed_dim // 2)
        self.gain_in = _gain_in(1, num_features)
        self.gain_out = nn.Parameter(torch.tensor([0.1]))
        self.mlp = MLP(e2 + feature_dim, embed_dim * num_features, 5, generator)
        self.out = Dense(embed_dim * num_features + e2, 2 * input_dim, generator)

    def forward(self, inputs, feature, slider, omega):
        _input = self.rff2(inputs / (1.3 * math.pi) - 1.0)
        feature = apply_gain(feature, self.gain_in, self.num_features)
        h = self.mlp(torch.cat([_input, feature], dim=-1))
        a, b = self.out(torch.cat([h, _input], dim=-1)).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU
        gate = torch.tanh((slider - 1.0) * self.gain_out)
        return inputs + omega * x * gate


class AMBlock(nn.Module):
    """Amplitude modulation block (blocks.py:73-99)."""

    def __init__(self, input_dim, embed_dim, num_features, feature_dim, generator):
        super().__init__()
        self.num_features = num_features
        self.rff2 = RFF2(input_dim, embed_dim // 2)
        e2 = 2 * (embed_dim // 2)
        self.gain_in = _gain_in(2, num_features)
        self.mlp = MLP(e2 + feature_dim, embed_dim * num_features, 5, generator)
        self.out = Dense(embed_dim * num_features + e2, 2 * input_dim, generator)

    def forward(self, inputs, feature, slider):
        _input = self.rff2(inputs * 110.0 - 0.55)
        feature = apply_gain(feature, self.gain_in, self.num_features)
        h = self.mlp(torch.cat([_input, feature], dim=-1))
        a, b = self.out(torch.cat([h, _input], dim=-1)).chunk(2, dim=-1)
        return inputs * (1.0 + a * torch.sigmoid(b))


class ModeEstimator(nn.Module):
    """Physical params -> (mode amps, monotone mode freqs) (blocks.py:171-229)."""

    def __init__(self, n_modes, hidden_dim, kappa_scale=None, gamma_scale=None,
                 inharmonic=True, sr=48000, generator=None):
        super().__init__()
        self.n_modes, self.sr, self.inharmonic = n_modes, sr, inharmonic
        self.kappa_scale, self.gamma_scale = kappa_scale, gamma_scale
        self.rff = RFF([1.0] * 5, hidden_dim // 2)
        self.amp_mlp = MLP(self.rff.out_dim, hidden_dim, 2, generator)
        self.amp_out = Dense(hidden_dim, n_modes, generator)
        if inharmonic:
            self.freq_mlp = MLP(self.rff.out_dim, hidden_dim, 2, generator)
            self.freq_out = Dense(hidden_dim, n_modes, generator)

    @staticmethod
    def _norm(x, scale):
        if scale is None:
            return x
        lo = min(scale)
        return (x - lo) / (max(scale) - lo)

    def forward(self, u_0, x_p, kappa, gamma):
        """u_0: (b, 1, Nx); x_p/kappa/gamma: (b, 1, 1)."""
        # ties pick the first index, as jnp.argmax does
        p_x = (torch.argmax(u_0, dim=-1, keepdim=True).double() / 255.0).to(u_0.dtype)
        p_a = torch.amax(u_0, dim=-1, keepdim=True) / 0.02
        con = torch.cat([p_x, p_a, x_p, self._norm(kappa, self.kappa_scale),
                         self._norm(gamma, self.gamma_scale)], dim=-1)  # (b, 1, 5)
        con = self.rff(con)
        mode_amps = torch.tanh(1e-3 * self.amp_out(self.amp_mlp(con)))
        if self.inharmonic:
            f = torch.sigmoid(self.freq_out(self.freq_mlp(con)))
            mode_freq = running_sum(0.3 * f, dim=-1)  # cumsum in a fixed order
        else:
            ints = torch.arange(1, self.n_modes + 1, dtype=u_0.dtype, device=u_0.device)
            mode_freq = gamma / self.sr * (2 * math.pi) * ints
        return mode_amps, mode_freq
