"""The port's DMSP modules against the JAX package's.

Every block, both mode estimators and the whole ``Synthesizer`` (mlp and
physics estimators, ``amp_adaptive_noise`` on and off, the harmonic
``DDSPCore`` with and without FM) run on the same seeded numpy inputs at
the JAX tests' small widths, with the flax variables carried into the port
by ``models/convert.py`` (perturbed first, so that every leaf's place
matters).  The noise branch's uniform draw is fixed on both sides to one
seeded numpy array by monkeypatching the draw.  float32 on both sides;
the JAX package runs with x64 enabled (tests/conftest.py), where a few of
its intermediates promote to float64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.models import blocks as jblocks
from torch_fdtd_string_tpu.models import physmodes as jphys
from torch_fdtd_string_tpu.models import synthesizer as jsyn
from torch_fdtd_string_tpu.ops import ddsp as jddsp
from torch_fdtd_string_tpu.ops import modal as jmodal
from torch_fdtd_string_tpu.utils import vnv as jvnv
from torch_fdtd_string_tpu_torch.models import blocks as tblocks
from torch_fdtd_string_tpu_torch.models import physmodes as tphys
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables
from torch_fdtd_string_tpu_torch.ops import ddsp as tddsp
from torch_fdtd_string_tpu_torch.ops import modal as tmodal
from torch_fdtd_string_tpu_torch.utils import vnv as tvnv

SR = 48000
KAPPA, GAMMA = (0.01, 0.03), (196.0, 880.0)
# the small widths of the JAX package's own DMSP tests (test_trainer.py)
SMALL = dict(n_modes=8, n_bands=9, hidden_dim=16, embed_dim=8, block_size=64)
# float32 bank over 1 s at 40 modes (test_modal_synth_float32_phase_sum)
PHASE_SUM_BOUND = 2e-2


def rel_err(a, b):
    """max |a - b| / max |a|, a the JAX value."""
    a = np.asarray(a, np.float64)
    b = (b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def fixed_uniform(shape):
    """The noise draw both packages get in the equality tests."""
    return np.random.default_rng(123).random(tuple(shape)).astype(np.float32)


def fix_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None, **kw: jnp.asarray(fixed_uniform(shape)))
    monkeypatch.setattr(tsyn, "uniform",
                        lambda shape, generator, device, dtype: torch.as_tensor(
                            fixed_uniform(shape), device=device))


def perturb(variables, seed=0):
    """The flax variables as numpy, every ``params`` leaf moved by a few
    percent of its scale (PReLU slopes, gains and biases then differ per
    leaf); ``constants`` as they are."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        return (x + 0.05 * (np.abs(x).mean() + 0.01) * rng.standard_normal(x.shape)).astype(x.dtype)

    out = {"params": jax.tree.map(move, dict(variables["params"]))}
    out["constants"] = jax.tree.map(np.asarray, dict(variables.get("constants", {})))
    return out


def flax_init(module, *args):
    return module.init({"params": jax.random.key(0), "noise": jax.random.key(1)}, *args)


def pluck_profiles(rng, B, Nx):
    """(B, 1, Nx) triangular plucks, peak 0.005-0.02 at a random point."""
    u0 = np.zeros((B, 1, Nx), np.float32)
    for b in range(B):
        px = int(rng.integers(Nx // 8, Nx - Nx // 8))
        u0[b, 0] = np.interp(np.arange(Nx), [0, px, Nx - 1], [0, rng.uniform(0.005, 0.02), 0])
    return u0


def synth_inputs(B=3, Nt=1024, Nx=64, n_modes=8, block=64, seed=0):
    """A prepared batch (``tasks/synthesize.py::prepare_batch``'s keys) of
    numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    nf = Nt // block + 1
    f0 = rng.uniform(200.0, 400.0, (B, 1)) * (1.0 + 0.01 * np.linspace(0, 1, nf))
    t60 = np.stack([np.array([[1000.0, rng.uniform(8, 20)], [100.0, rng.uniform(5, 15)]])
                    for _ in range(B)])
    return dict(
        xg=rng.uniform(0.1, 0.9, (B, 1)).astype(np.float32),
        tg=np.tile(np.arange(Nt) / SR, (B, 1)).astype(np.float32),
        ka=rng.uniform(*KAPPA, (B, 1)).astype(np.float32),
        al=rng.uniform(1.0, 20.0, (B, 1)).astype(np.float32),
        t60=t60.astype(np.float32),
        f_k=np.cumsum(rng.uniform(0.01, 0.05, (B, 1, n_modes)), -1).astype(np.float32),
        c_k=rng.uniform(-0.01, 0.01, (B, 1, n_modes)).astype(np.float32),
        f_0=f0.astype(np.float32),
        u_0=pluck_profiles(rng, B, Nx),
    )


# ---- ops ----------------------------------------------------------------------

def test_upsample_is_torch_linear_interpolation():
    """The JAX package's upsample re-implements F.interpolate(linear,
    align_corners=False); float32 on both sides, 2 ulp."""
    x = np.random.default_rng(0).standard_normal((3, 17, 5)).astype(np.float32)
    for factor in (1, 4, 64):
        got = tddsp.upsample(torch.as_tensor(x), factor)
        want = np.asarray(jddsp.upsample(jnp.asarray(x), factor))
        assert rel_err(want, got) < 3e-7


@pytest.mark.parametrize("op", ["scale_function", "remove_above_nyquist",
                                "remove_above_nyquist_mode", "amp_to_impulse_response",
                                "fft_convolve"])
def test_ddsp_op_matches_jax(op):
    """Each op on one seeded float32 input, within the stated relative
    bound (the JAX window and FFTs promote to float64 under x64)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 6, 9)).astype(np.float32)
    if op == "scale_function":
        j, t, tol = jddsp.scale_function(jnp.asarray(a * 4)), tddsp.scale_function(
            torch.as_tensor(a * 4)), 1e-6
    elif op == "remove_above_nyquist":
        pitch = rng.uniform(1000, 5000, (2, 6, 1)).astype(np.float32)
        j = jddsp.remove_above_nyquist(jnp.asarray(a), jnp.asarray(pitch), SR)
        t = tddsp.remove_above_nyquist(torch.as_tensor(a), torch.as_tensor(pitch), SR)
        tol = 0.0
    elif op == "remove_above_nyquist_mode":
        hz = rng.uniform(0, SR, (2, 6, 9)).astype(np.float32)
        j = jddsp.remove_above_nyquist_mode(jnp.asarray(a), jnp.asarray(hz), SR)
        t = tddsp.remove_above_nyquist_mode(torch.as_tensor(a), torch.as_tensor(hz), SR)
        tol = 0.0
        assert rel_err(jmodal.remove_above_nyquist_mode(jnp.asarray(a), jnp.asarray(hz), SR),
                       tmodal.remove_above_nyquist_mode(torch.as_tensor(a),
                                                        torch.as_tensor(hz), SR)) == 0.0
    elif op == "amp_to_impulse_response":
        j = jddsp.amp_to_impulse_response(jnp.asarray(np.abs(a)), 64)
        t = tddsp.amp_to_impulse_response(torch.as_tensor(np.abs(a)), 64)
        tol = 1e-6
    else:
        k = rng.standard_normal((2, 6, 64)).astype(np.float32)
        s = rng.standard_normal((2, 6, 64)).astype(np.float32)
        j = jddsp.fft_convolve(jnp.asarray(s), jnp.asarray(k))
        t = tddsp.fft_convolve(torch.as_tensor(s), torch.as_tensor(k))
        tol = 1e-6
    assert rel_err(j, t) <= tol, op


@pytest.mark.parametrize("n,bound", [(2400, 1e-10), (SR, 2e-8)], ids=["50ms", "1s"])
def test_modal_synth_float64(n, bound):
    """The cosine bank in float64, held to the JAX package's at 1e-10 of
    its scale over 50 ms.  The only difference is the phase sum's order:
    torch's CPU cumsum is numpy's sequential sum, XLA's is not, and the two
    phases part by 3.7e-8 rad at 1 s (3.6e4 rad), which moves the bank by
    4.2e-9 of its scale (measured); bound 2e-8 there."""
    rng = np.random.default_rng(2)
    freqs = np.cumsum(rng.uniform(0.01, 0.1, (2, 1, 12)), -1) * np.ones((1, n, 1))
    coefs = rng.uniform(-0.01, 0.01, (2, 1, 12))
    damps = np.exp(-np.arange(n) / SR)[None, :, None] * np.ones((2, 1, 1))
    j = jmodal.modal_synth(jnp.asarray(freqs), jnp.asarray(coefs), jnp.asarray(damps))
    t = tmodal.modal_synth(*(torch.as_tensor(x) for x in (freqs, coefs, damps)))
    assert t.dtype == torch.float64 and rel_err(j, t) < bound


def test_harmonic_synth_float64():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(100, 400, (2, 4800, 1))
    amps = rng.uniform(0, 1, (2, 4800, 6))
    j = jmodal.harmonic_synth(jnp.asarray(f0), jnp.asarray(amps), SR)
    t = tmodal.harmonic_synth(torch.as_tensor(f0), torch.as_tensor(amps), SR)
    assert rel_err(j, t) < 1e-10


def test_modal_synth_float32_phase_sum():
    """float32 at synth-dmsp's item length (1 s) and mode count (40): the
    phase sums reach 7.6e4 rad, which float32 resolves only to ~8e-3 rad.
    The JAX bank sums in float32 (5.2e-3 of the bank's scale off the
    float64 bank, measured on the CPU; bound PHASE_SUM_BOUND = 2e-2); the
    port accumulates in float64 and wraps (``ops/modal.py::phase_sum``):
    1.4e-7 off it, bound 2e-6."""
    rng = np.random.default_rng(4)
    freqs = np.cumsum(rng.uniform(0.01, 0.06, (1, 1, 40)), -1).astype(np.float32)
    freqs = np.ascontiguousarray(np.broadcast_to(freqs, (1, SR, 40)))
    coefs = rng.uniform(-0.01, 0.01, (1, 1, 40)).astype(np.float32)
    damps = np.ones((1, SR, 1), np.float32)
    j = np.asarray(jmodal.modal_synth(jnp.asarray(freqs), jnp.asarray(coefs), jnp.asarray(damps)))
    t = tmodal.modal_synth(*(torch.as_tensor(x) for x in (freqs, coefs, damps)))
    exact = tmodal.modal_synth(*(torch.as_tensor(x).double() for x in (freqs, coefs, damps)))
    assert t.dtype == torch.float32
    assert rel_err(j, t) < PHASE_SUM_BOUND
    assert rel_err(exact.numpy(), j) < PHASE_SUM_BOUND
    assert rel_err(exact.numpy(), t) < 2e-6


def test_vnv():
    est, tgt = np.array([100.0, 202.0, 0.5]), np.array([101.0, 200.0, 0.0])
    np.testing.assert_array_equal(tvnv.relative_detune_error(est, tgt),
                                  jvnv.relative_detune_error(est, tgt))


def test_port_noise_draw_statistics():
    """The port's own draw (no monkeypatch): ``2u - 1`` in [-1, 1), mean
    within 5 standard errors of 0, reproducible from the generator."""
    shape = (64, 40, 256)
    u = tsyn.uniform(shape, torch.Generator().manual_seed(5), "cpu", torch.float32)
    n = 2.0 * u - 1.0
    assert n.shape == shape and float(n.min()) >= -1.0 and float(n.max()) < 1.0
    assert abs(float(n.double().mean())) < 5 * (1 / math.sqrt(3)) / math.sqrt(n.numel())
    again = tsyn.uniform(shape, torch.Generator().manual_seed(5), "cpu", torch.float32)
    assert torch.equal(u, again)


# ---- blocks -------------------------------------------------------------------

def _block_case(name, rng):
    """(flax module, port module, inputs) of one block at small width."""
    B, F_, n, e, nf = 3, 5, 8, 8, 7
    feat = rng.uniform(-1, 1, (B, F_, nf * e)).astype(np.float32)
    if name == "mlp":
        return jblocks.MLP(16, 3), tblocks.MLP(10, 16, 3, None), [
            rng.standard_normal((B, F_, 10)).astype(np.float32)]
    if name == "rff":
        return jblocks.RFF([1.0, 0.5, 2.0], 4), tblocks.RFF([1.0, 0.5, 2.0], 4), [
            rng.uniform(0, 1, (B, F_, 3)).astype(np.float32)]
    if name == "rff2":
        return jblocks.RFF2(n, 6), tblocks.RFF2(n, 6), [
            rng.uniform(-1, 1, (B, F_, n)).astype(np.float32)]
    if name == "fm":
        freqs = np.cumsum(rng.uniform(0.01, 0.05, (B, F_, n)), -1).astype(np.float32)
        slider = rng.uniform(1, 20, (B, F_, 1)).astype(np.float32)
        omega = rng.uniform(0.02, 0.05, (B, F_, 1)).astype(np.float32)
        return (jblocks.FMBlock(n, e, nf), tblocks.FMBlock(n, e, nf, nf * e, None),
                [freqs, feat, slider, omega])
    if name == "am":
        coefs = rng.uniform(-0.01, 0.01, (B, F_, n)).astype(np.float32)
        times = rng.uniform(0, 0.3, (B, F_, 1)).astype(np.float32)
        return (jblocks.AMBlock(n, e, nf), tblocks.AMBlock(n, e, nf, nf * e, None),
                [coefs, feat, times])
    inharmonic = name == "estimator-inharmonic"
    u0 = pluck_profiles(rng, B, 64)
    u0[0, 0, 20] = u0[0, 0, 21] = u0[0, 0].max()  # a tie: the first index wins
    args = [u0, rng.uniform(0.1, 0.9, (B, 1, 1)).astype(np.float32),
            rng.uniform(*KAPPA, (B, 1, 1)).astype(np.float32),
            rng.uniform(400, 800, (B, 1, 1)).astype(np.float32)]
    return (jblocks.ModeEstimator(n, 16, KAPPA, GAMMA, inharmonic=inharmonic),
            tblocks.ModeEstimator(n, 16, KAPPA, GAMMA, inharmonic=inharmonic), args)


# largest relative difference per block, measured on the CPU; bound 10x it
# (and at least 1e-6)
BLOCK_BOUNDS = {"mlp": 1e-6, "rff": 1e-6, "rff2": 1e-6, "fm": 1e-6, "am": 1e-6,
                "estimator-inharmonic": 1e-6, "estimator-harmonic": 1e-6}


@pytest.mark.parametrize("name", sorted(BLOCK_BOUNDS))
def test_block_matches_jax(name):
    rng = np.random.default_rng(7)
    jmod, tmod, args = _block_case(name, rng)
    variables = perturb(flax_init(jmod, *(jnp.asarray(a) for a in args)))
    load_jax_variables(tmod, variables)
    want = jmod.apply(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tmod(*(torch.as_tensor(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        assert rel_err(w, g) <= BLOCK_BOUNDS[name], (name, rel_err(w, g))


def test_rff_constant_and_gain_inits_match_jax():
    """The numpy-seeded values are the JAX package's exactly: RFF.N
    (default_rng(0)), FMBlock/AMBlock gain_in (default_rng(1), (2)), the
    scalar inits."""
    rng = np.random.default_rng(0)
    for name in ("rff", "fm", "am"):
        jmod, tmod, args = _block_case(name, rng)
        v = flax_init(jmod, *(jnp.asarray(a) for a in args))
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(dict(v))[0]}
        own = {k: x.numpy() for k, x in tmod.state_dict().items()}
        if name == "rff":
            np.testing.assert_array_equal(own["N"], flat["constants/N"])
            np.testing.assert_array_equal(own["e"], flat["params/e"])
        else:
            np.testing.assert_array_equal(own["gain_in"], flat["params/gain_in"])
            np.testing.assert_array_equal(own["rff2.e"], flat["params/RFF2_0/e"])
            np.testing.assert_array_equal(own["mlp.prelu"], [0.25] * 5)
        if name == "fm":
            np.testing.assert_array_equal(own["gain_out"], flat["params/gain_out"])


def test_dense_init_distribution_matches_flax():
    """Dense kernels are lecun-normal as flax draws them: the same
    deviation (within 3%), truncation at two deviations, zero bias."""
    from flax import linen as nn

    fan_in, out = 256, 512
    jk = np.asarray(nn.Dense(out).init(jax.random.key(0), jnp.zeros((1, fan_in)))["params"]["kernel"])
    lin = tblocks.Dense(fan_in, out, torch.Generator().manual_seed(0))
    w = lin.weight.detach().numpy()
    assert w.shape == (out, fan_in) and not lin.bias.detach().abs().any()
    assert abs(w.std() / jk.std() - 1.0) < 0.03
    std = math.sqrt(1.0 / fan_in) / tblocks._TRUNC_STD
    assert np.abs(w).max() <= 2 * std + 1e-7 and np.abs(jk).max() <= 2 * std + 1e-7
    again = tblocks.Dense(fan_in, out, torch.Generator().manual_seed(0)).weight
    assert torch.equal(lin.weight, again)


# ---- the physics estimator ----------------------------------------------------

def test_mu1_tables_match_jax():
    """The port's table, built by its own analytic solver into its own
    cache, equals the JAX package's to 1e-12."""
    jk, je, jo = jphys.mu1_tables(*KAPPA, 28)
    tk, te, to = tphys.mu1_tables(*KAPPA, 28)
    np.testing.assert_array_equal(tk, jk)
    assert np.abs(te - je).max() < 1e-12 * np.abs(je).max()
    assert np.abs(to - jo).max() < 1e-12 * np.abs(jo).max()


def test_physics_estimator_matches_jax():
    """Mode frequencies within 1e-6, amplitudes within 2e-5 of their scale
    (measured 0.0 and 4.0e-7: the JAX shapes promote to float64 under x64,
    the port's normal equations are float32)."""
    rng = np.random.default_rng(8)
    B, Nx = 5, 64
    args = [pluck_profiles(rng, B, Nx), rng.uniform(0.1, 0.9, (B, 1, 1)).astype(np.float32),
            rng.uniform(*KAPPA, (B, 1, 1)).astype(np.float32),
            rng.uniform(400, 800, (B, 1, 1)).astype(np.float32),
            np.tile(np.array([[[1000.0, 12.0], [100.0, 8.0]]], np.float32), (B, 1, 1))]
    jmod = jphys.PhysicsModeEstimator(12, KAPPA)
    amps_j, freq_j = jmod.apply({}, *(jnp.asarray(a) for a in args))
    tmod = tphys.PhysicsModeEstimator(12, KAPPA)
    assert not tmod.state_dict()  # no variables to carry
    amps_t, freq_t = tmod(*(torch.as_tensor(a) for a in args))
    assert rel_err(freq_j, freq_t) < 1e-6
    assert rel_err(amps_j, amps_t) < 2e-5


# ---- the synthesizer ----------------------------------------------------------

SYNTH_CASES = {
    "mlp": dict(mode_estimator="mlp"),
    "mlp-adaptive": dict(mode_estimator="mlp", amp_adaptive_noise=True, noise_floor=0.3),
    "physics": dict(mode_estimator="physics"),
    "physics-adaptive": dict(mode_estimator="physics", amp_adaptive_noise=True),
    "ddsp": dict(harmonic="harmonic"),
    "ddsp-fm": dict(harmonic="harmonic", ddsp_fm=True),
}
# relative to scale, measured on the CPU over the twelve cases below: ut
# over 1024 samples at most 4.4e-5 (the JAX phase sum's f32 rounding and
# the modes' differences summed into the phase); the phase-free outputs (both estimators' modes, freq_m,
# coef_m) at most 2.3e-5, the noise branch alone 5.7e-5.  The conditioning
# RFF maps these inputs' features (up to 5.9, the rescaled sig_1) to sines
# of up to 510 rad, where one ulp of the argument is 3e-5 of float32
# sine: that, not the blocks, sets these floors.  Bounds 10x the largest
# reading of each kind
UT_BOUND, PHASE_FREE_BOUND, NOISE_BOUND = 5e-4, 2.5e-4, 6e-4


def run_both(case, prep, gt_modes, monkeypatch, seed=0):
    """The JAX and the port's Synthesizer of ``case`` on ``prep``, the
    port's carrying the JAX one's perturbed variables: both outputs, and
    the port's model."""
    fix_noise(monkeypatch)
    kw = dict(SMALL, **SYNTH_CASES[case])
    jm = jsyn.Synthesizer(**kw)
    inharmonic = jm.inharmonic
    keys = ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")
    args = [jnp.asarray(prep[k]) for k in keys]
    variables = perturb(flax_init(jm, args, jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"])),
                        seed)
    if not (gt_modes and inharmonic):
        args[5] = args[6] = None
    want = jm.apply(variables, args, jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"]),
                    rngs={"noise": jax.random.key(2)})
    tm = tsyn.Synthesizer(**kw, generator=torch.Generator().manual_seed(seed))
    load_jax_variables(tm, variables)
    targs = [torch.as_tensor(prep[k]) for k in keys]
    if not (gt_modes and inharmonic):
        targs[5] = targs[6] = None
    with torch.no_grad():
        got = tm(targs, torch.as_tensor(prep["f_0"]), torch.as_tensor(prep["u_0"]))
    return want, got, tm


@pytest.mark.parametrize("gt_modes", [True, False], ids=["dataset-modes", "own-modes"])
@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_synthesizer_matches_jax(case, gt_modes, monkeypatch):
    prep = synth_inputs()
    (ut_j, est_j, core_j), (ut_t, est_t, core_t), _ = run_both(case, prep, gt_modes,
                                                                monkeypatch)
    assert ut_t.shape == (3, 1024) and ut_t.dtype == torch.float32
    assert torch.isfinite(ut_t).all()
    assert rel_err(ut_j, ut_t) < UT_BOUND, rel_err(ut_j, ut_t)
    for w, g in zip(est_j + core_j, est_t + core_t):
        assert rel_err(w, g) < PHASE_FREE_BOUND, rel_err(w, g)


def test_noise_branch_matches_jax(monkeypatch):
    """The filtered noise alone (the same modes, coefficients zeroed, so
    the bank is silent): no phase sum."""
    prep = synth_inputs()
    prep["c_k"] = np.zeros_like(prep["c_k"])
    (ut_j, _, _), (ut_t, _, _), _ = run_both("mlp", prep, True, monkeypatch)
    assert np.abs(np.asarray(ut_j)).max() > 0
    assert rel_err(ut_j, ut_t) < NOISE_BOUND


# the full-width model's float32 waveform over 1 s against its float64
# twin (same weights, same noise), with realistic modes: measured on the
# CPU 3.3e-4 of scale with the physics estimator's own modes, 2.1e-4 with
# the untrained mlp driven by the dataset-like modes: the float32 modes'
# rounding, summed into the phase; bound 6x.  (The
# untrained mlp on its own modes, cumsum(0.3 sigmoid) up to 6 rad/sample,
# reaches 3e5 rad of phase and reads 1.1e-2: float32 modes do not resolve
# that waveform, so no bound is claimed there.)
WAVE_BOUND = 2e-3


@pytest.mark.parametrize("case", ["physics-own-modes", "mlp-dataset-modes"])
def test_full_width_float32_waveform(case, monkeypatch):
    fix_noise(monkeypatch)
    monkeypatch.setattr(tsyn, "uniform", lambda shape, generator, device, dtype: torch.as_tensor(
        fixed_uniform(shape), dtype=dtype))
    rng = np.random.default_rng(11)
    B, Nt = 8, SR
    nf = Nt // 256 + 1
    f0 = rng.uniform(98.0, 440.0, (B, 1)) * (1.0 + 0.02 * np.sin(np.linspace(0, 6, nf)))
    prep = synth_inputs(B=B, Nt=Nt, Nx=256, n_modes=40, block=256, seed=11)
    prep["f_0"] = f0.astype(np.float32)
    keys = ("xg", "tg", "ka", "al", "t60")
    phys = tsyn.Synthesizer(mode_estimator="physics").double()
    args64 = [torch.as_tensor(prep[k]).double() for k in keys]
    with torch.no_grad():
        _, (fk, ck), _ = phys(args64 + [None, None], torch.as_tensor(prep["f_0"]).double(),
                              torch.as_tensor(prep["u_0"]).double())
        est = case.split("-")[0]
        m = tsyn.Synthesizer(mode_estimator=est, generator=torch.Generator().manual_seed(17))
        modes = [None, None] if est == "physics" else [fk, ck]
        args = [torch.as_tensor(prep[k]) for k in keys]
        ut32 = m(args + [x if x is None else x.float() for x in modes],
                 torch.as_tensor(prep["f_0"]), torch.as_tensor(prep["u_0"]))[0]
        ut64 = m.double()(args64 + modes, torch.as_tensor(prep["f_0"]).double(),
                          torch.as_tensor(prep["u_0"]).double())[0]
    assert ut32.dtype == torch.float32 and ut64.dtype == torch.float64
    assert rel_err(ut64.numpy(), ut32) < WAVE_BOUND, rel_err(ut64.numpy(), ut32)


def test_synthesizer_stages_compose(monkeypatch):
    """``condition`` + the core's ``modulate`` / ``harmonic`` / ``noise``
    are the forward, bit for bit."""
    prep = synth_inputs(seed=3)
    _, (ut, _, (freq_m, coef_m)), tm = run_both("physics", prep, False, monkeypatch)
    keys = ("xg", "tg", "ka", "al", "t60")
    params = [torch.as_tensor(prep[k]) for k in keys] + [None, None]
    with torch.no_grad():
        (hidden, mf, mc, times, alpha, omega, n), _ = tm.condition(
            params, torch.as_tensor(prep["f_0"]), torch.as_tensor(prep["u_0"]))
        fm, cm = tm.core.modulate(hidden, mf, mc, times, alpha, omega)
        out = tm.core.harmonic(fm, cm, n) + tm.core.noise(hidden, cm, alpha, n, None)
    assert torch.equal(fm, freq_m) and torch.equal(cm, coef_m)
    assert torch.equal(out[..., 0], ut)
