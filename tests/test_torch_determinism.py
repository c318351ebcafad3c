"""The DMSP step's fixed-order forms against the ops they replace.

The port writes four ops of the train step in forms whose CUDA forward and
backward run in a fixed order (``torch.use_deterministic_algorithms``
refuses the CUDA forms of the originals, whose backwards accumulate with
atomics): ``ops/ddsp.py::upsample_fixed_order``, which ``upsample`` runs
on a CUDA tensor (``F.interpolate(mode="linear")``),
``ops/modal.py::running_sum`` (``torch.cumsum``),
``models/losses.py::reflect_pad`` (``F.pad(mode="reflect")``) and the
physics estimator's one-hot selection (``torch.gather``).  Each is held in
float64 to the op it replaces and to the JAX package's counterpart, values
and gradients, at 1e-12 of scale; then two float32 train steps of the
small model repeat bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_dmsp_modules import KAPPA, SMALL, pluck_profiles, synth_inputs
from torch_fdtd_string_tpu.models import physmodes as jphys
from torch_fdtd_string_tpu.ops import ddsp as jddsp
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.models import losses as tlosses
from torch_fdtd_string_tpu_torch.models import physmodes as tphys
from torch_fdtd_string_tpu_torch.ops import ddsp as tddsp
from torch_fdtd_string_tpu_torch.ops import modal as tmodal
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.utils.config import compose

BOUND = 1e-12  # of each value's or gradient's scale, float64


def scaled(a, b):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def grad_of(fn, x, g):
    """The vector-Jacobian product of ``fn`` at ``x`` (numpy) with ``g``."""
    xt = torch.as_tensor(x).requires_grad_(True)
    (out,) = torch.autograd.grad(fn(xt), xt, torch.as_tensor(g))
    return out


@pytest.mark.parametrize("factor, T", [(256, 188), (64, 17), (5, 9), (1, 4), (3, 1)])
def test_upsample_equals_interpolate_and_jax(factor, T):
    rng = np.random.default_rng(factor + T)
    x = rng.standard_normal((3, T, 7))
    g = rng.standard_normal((3, T * factor, 7))

    def interp(t):
        return F.interpolate(t.transpose(1, 2), scale_factor=factor, mode="linear",
                             align_corners=False).transpose(1, 2)

    got = tddsp.upsample_fixed_order(torch.as_tensor(x), factor)
    want_j, vjp = jax.vjp(lambda s: jddsp.upsample(s, factor), jnp.asarray(x))
    assert scaled(interp(torch.as_tensor(x)), got) < BOUND
    assert scaled(want_j, got) < BOUND
    # on the CPU upsample is F.interpolate itself
    assert torch.equal(tddsp.upsample(torch.as_tensor(x), factor), interp(torch.as_tensor(x)))
    grad = grad_of(lambda t: tddsp.upsample_fixed_order(t, factor), x, g)
    assert scaled(grad_of(interp, x, g), grad) < BOUND
    assert scaled(vjp(jnp.asarray(g))[0], grad) < BOUND


@pytest.mark.parametrize("shape, dim", [((2, 1000, 9), -2), ((3, 1, 40), -1),
                                        ((4, 48000 // 64, 5), 1), ((130, 3), 0)])
def test_running_sum_equals_cumsum_and_jax(shape, dim):
    """In blocks of 128 with a carry between them; 1,000 samples leave a
    partial block."""
    rng = np.random.default_rng(len(shape) + shape[0])
    x = rng.uniform(0.0, 0.1, shape)
    g = rng.standard_normal(shape)
    got = tmodal.running_sum(torch.as_tensor(x), dim=dim)
    assert scaled(torch.cumsum(torch.as_tensor(x), dim), got) < BOUND
    want_j, vjp = jax.vjp(lambda s: jnp.cumsum(s, axis=dim), jnp.asarray(x))
    assert scaled(want_j, got) < BOUND
    grad = grad_of(lambda t: tmodal.running_sum(t, dim=dim), x, g)
    assert scaled(grad_of(lambda t: torch.cumsum(t, dim), x, g), grad) < BOUND
    assert scaled(vjp(jnp.asarray(g))[0], grad) < BOUND


def test_phase_sum_wraps_the_running_sum():
    """Below float64 the phase is the float64 running sum wrapped to
    [0, 2 pi) and rounded once."""
    x = np.random.default_rng(3).uniform(0.0, 0.2, (2, 48000, 3)).astype(np.float32)
    got = tmodal.phase_sum(torch.as_tensor(x))
    want = np.remainder(np.cumsum(x.astype(np.float64), axis=-2), 2 * np.pi).astype(np.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 4.8e-7  # one float32 rounding near 2 pi


@pytest.mark.parametrize("pad", [1, 512])
def test_reflect_pad_and_stft_equal_f_pad(pad):
    rng = np.random.default_rng(pad)
    x = rng.standard_normal((4, 1500))
    g = rng.standard_normal((4, 1500 + 2 * pad))

    def fpad(t):
        return F.pad(t[:, None], (pad, pad), mode="reflect")[:, 0]

    assert scaled(fpad(torch.as_tensor(x)), tlosses.reflect_pad(torch.as_tensor(x), pad)) == 0.0
    assert scaled(grad_of(fpad, x, g), grad_of(lambda t: tlosses.reflect_pad(t, pad), x, g)) \
        < BOUND
    with pytest.raises(ValueError, match="reflect padding"):
        tlosses.stft_mag(torch.zeros(3, 512, dtype=torch.float64), 1024, 256)


def test_take_along_equals_gather():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 24))
    order = torch.as_tensor(np.argsort(rng.standard_normal((5, 24)), -1)[:, :12])
    g = rng.standard_normal((5, 12))
    assert scaled(torch.gather(torch.as_tensor(x), -1, order),
                  tphys.take_along(torch.as_tensor(x), order)) == 0.0
    assert scaled(grad_of(lambda t: torch.gather(t, -1, order), x, g),
                  grad_of(lambda t: tphys.take_along(t, order), x, g)) == 0.0


def test_physics_estimator_equals_jax_float64():
    """The estimator's modes, merged from both families in ascending
    frequency by ``take_along``, and their gradient through the amplitude
    fit to the pluck profile, against the JAX estimator in float64."""
    rng = np.random.default_rng(8)
    B, Nx = 5, 64
    args = [pluck_profiles(rng, B, Nx), rng.uniform(0.1, 0.9, (B, 1, 1)),
            rng.uniform(*KAPPA, (B, 1, 1)), rng.uniform(400, 800, (B, 1, 1)),
            np.tile(np.array([[[1000.0, 12.0], [100.0, 8.0]]]), (B, 1, 1))]
    args = [np.asarray(a, np.float64) for a in args]
    g_amp = rng.standard_normal((B, 1, 12))
    jmod = jphys.PhysicsModeEstimator(12, KAPPA)
    (amps_j, freq_j), vjp = jax.vjp(lambda u: jmod.apply({}, u, *map(jnp.asarray, args[1:])),
                                    jnp.asarray(args[0]))
    tmod = tphys.PhysicsModeEstimator(12, KAPPA).double()
    u0 = torch.as_tensor(args[0]).requires_grad_(True)
    amps_t, freq_t = tmod(u0, *(torch.as_tensor(a) for a in args[1:]))
    (grad_t,) = torch.autograd.grad(amps_t, u0, torch.as_tensor(g_amp))
    assert scaled(freq_j, freq_t) < BOUND and scaled(amps_j, amps_t) < BOUND
    assert scaled(vjp((jnp.asarray(g_amp), jnp.zeros_like(freq_j)))[0], grad_t) < BOUND


def test_two_float32_steps_repeat_bit_for_bit():
    """Two train steps of the small model (synth-dmsp's optimizer and
    losses, physics and mlp) from the same seed on the same batches and
    noise generator: the losses and every parameter equal bit for bit."""
    prep = synth_inputs(B=3, Nt=1024, n_modes=SMALL["n_modes"], block=SMALL["block_size"])
    rng = np.random.default_rng(100)
    prep["gt"] = rng.normal(0, 0.01, (3, 1024)).astype(np.float32)
    prep["gt_f0"] = (prep["f_0"] / 48000 * 2 * np.pi).astype(np.float32)
    batch = tsynth.to_device(prep, "cpu")
    for est in ("physics", "mlp"):
        args = compose(trun.CONFIG_DIR, ["experiment=synth-dmsp", "proc.cpu=true",
                                         f"model.mode_estimator={est}"]
                       + [f"model.{k}={v}" for k, v in SMALL.items()])
        runs = []
        for _ in range(2):
            setup = ttrainer.build_training(args, torch.device("cpu"), 10, sharded=False)
            state = ttrainer.train_state(setup.model, setup.optimizer, 0, 0, "cpu")
            losses = [setup.train_step(state, batch)[1] for _ in range(2)]
            runs.append((losses, dict(setup.model.named_parameters())))
        (l1, p1), (l2, p2) = runs
        assert all(torch.equal(a[k], b[k]) for a, b in zip(l1, l2) for k in a), est
        assert all(torch.equal(p1[k], p2[k]) for k in p1), est
