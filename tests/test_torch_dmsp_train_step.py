"""The DMSP train step in the port against the JAX package's.

The train step (``tasks/synthesize.py::make_train_step``) at the JAX
tests' small widths, one and three steps, both estimators, float32 and
float64, against JAX ``make_train_step``: the flax variables carried into
the port by ``models/convert.py``, the same function mapping the flax
gradient tree onto the port's parameter names, the noise draw fixed on
both sides; the JAX side of each estimator and dtype runs once, its three
steps serving the one-step case too.  The float64 forward, the physics
estimator's gradient, the PReLU's subgradient at a tie, the mode protocol
and the adaptive noise.  ``proc.train`` end to end is
``tests/test_torch_dmsp_train.py``.  float32 on both sides unless stated
(the JAX package with x64 on, tests/conftest.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import SMALL, fix_noise, flax_init, perturb, rel_err, synth_inputs
from torch_fdtd_string_tpu.models import optim as joptim
from torch_fdtd_string_tpu.models import synthesizer as jsyn
from torch_fdtd_string_tpu.models.losses import build_loss_registry as jregistry
from torch_fdtd_string_tpu.tasks import synthesize as jsynth
from torch_fdtd_string_tpu_torch.models import optim as toptim
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables, state_dict_from_jax
from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry as tregistry
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth

SR = 48000
CRITERIA = ["l1", "magspec", "melspec", "f0", "modefreq", "modeamps"]  # synth-dmsp's
KEYS = ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")

# ---- the train step -------------------------------------------------------------

def step_inputs(seed=0):
    """A prepared batch of 3 items of 1024 samples at SMALL's widths."""
    prep = synth_inputs(B=3, Nt=1024, n_modes=SMALL["n_modes"], block=SMALL["block_size"],
                        seed=seed)
    rng = np.random.default_rng(seed + 100)
    nf = prep["f_0"].shape[1]
    prep["gt"] = rng.normal(0, 0.01, (3, 1024)).astype(np.float32)
    prep["gt_f0"] = (prep["f_0"] / SR * 2 * np.pi * (1 + 0.01 * rng.standard_normal((3, nf)))
                     ).astype(np.float32)
    return prep


def jax_and_port(estimator, monkeypatch, dtype=torch.float32):
    """The JAX synthesizer and its perturbed variables, and the port's
    synthesizer carrying them, in ``dtype``; the noise fixed on both
    sides."""
    fix_noise(monkeypatch)
    monkeypatch.setattr(tsyn, "uniform", lambda shape, generator, device, dt: torch.as_tensor(
        np.random.default_rng(123).random(tuple(shape)).astype(np.float32), device=device).to(dt))
    kw = dict(SMALL, mode_estimator=estimator)
    prep = step_inputs()
    jm = jsyn.Synthesizer(**kw)
    variables = perturb(flax_init(jm, [jnp.asarray(prep[k]) for k in KEYS],
                                  jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"])), 3)
    tm = load_jax_variables(tsyn.Synthesizer(**kw), variables).to(dtype)
    if dtype == torch.float64:
        variables = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        prep = {k: v.astype(np.float64) for k, v in prep.items()}
    return jm, variables, tm, prep


def port_params(tm, tree, constants):
    """A flax parameter tree (parameters or gradients) under the port's
    parameter names."""
    sd = state_dict_from_jax(tm, {"params": tree, "constants": constants})
    return {k: sd[k] for k, _ in tm.named_parameters()}


# largest differences measured on the CPU over both estimators and 1 and 3
# steps of synth-dmsp's optimizer (radam, lr 1e-3, noam warmup 1000), the
# noise fixed, relative to scale (losses: each criterion's value;
# gradients and the parameters' movement: each tensor's).  float64 on both
# sides, where the packages run the same algorithm: losses 2.1e-7,
# gradients 2.7e-4, movement 3.2e-3.  The JAX package's float64 forward
# keeps float32 pieces (the noise filter's inverse FFT runs in complex64,
# ops/ddsp.py:59), so its waveform is ~1e-9 off the port's
# (test_float64_forward_matches_jax); the gradient's largest gap is one
# scalar whose gradient is a cancelling sum (core.am.rff2.e, physics).
# float32: losses 8.1e-5; the float32 gradient is far from the float64 one
# in both packages (the port's core.am.rff2.e 0.23 of scale with the
# physics estimator, the JAX package's 1.04): the gradient moves with the
# modal frequencies' last bits, and l1_loss floors the mean square at
# finfo(dtype).eps (PERF.md section 7).  So float32 holds the losses and
# the whole gradient's largest difference relative to its largest
# element, 1.45e-2.  Bounds 5-10x
BOUND = {"LOSS64": 2e-6, "GRAD64": 2.5e-3, "MOVE64": 2e-2, "LOSS32": 5e-4, "GRAD32": 1e-1}


SCHEDULE = ("noam", {"warmup_steps": 1000})  # synth-dmsp's optimizer and schedule


@functools.lru_cache(maxsize=None)
def jax_steps(estimator, dtype):
    """The JAX side of test_train_step_matches_jax, once per estimator and
    dtype: the first step's gradient, and each of three steps' losses and
    parameters after it, all under the port's names."""
    with pytest.MonkeyPatch.context() as mp:
        jm, variables, tm, prep = jax_and_port(estimator, mp, dtype)
        params, constants = variables["params"], variables["constants"]
        jreg = jregistry(SR, SR)
        jprep = {k: jnp.asarray(v) for k, v in prep.items()}

        # the gradient of the first step, in the JAX train step's own loss
        def loss_fn(p):
            out = jsynth.forward_outputs(jm, {"params": p, "constants": constants}, jprep,
                                         jax.random.key(0), jm.inharmonic)
            return jsynth.compute_losses(out, jreg, CRITERIA)[0]

        jgrad = port_params(tm, jax.grad(loss_fn)(params), constants)
        tx, _, _ = joptim.build("radam", {"lr": 1e-3}, *SCHEDULE)
        jstate = jsynth.TrainState(params, {"constants": constants}, tx.init(params), 0,
                                   jax.random.key(0))
        jstep = jsynth.make_train_step(jm, tx, jreg, CRITERIA, jm.inharmonic)
        steps = []
        for _ in range(3):
            jstate, jloss = jstep(jstate, jprep)
            steps.append(({k: np.asarray(v) for k, v in jloss.items()},
                          port_params(tm, jstate.params, constants)))
    return jgrad, steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("estimator", ["mlp", "physics"])
def test_train_step_matches_jax(estimator, n_steps, dtype, monkeypatch):
    jgrad, jsteps = jax_steps(estimator, dtype)
    _, _, tm, prep = jax_and_port(estimator, monkeypatch, dtype)
    treg = tregistry(SR, SR)
    f64 = dtype == torch.float64
    opt, _, _ = toptim.build(tm.parameters(), "radam", {"lr": 1e-3}, *SCHEDULE)
    tstate = tsynth.TrainState(tm, opt, 0, torch.Generator())
    tstep = tsynth.make_train_step(tm, opt, treg, CRITERIA, tm.inharmonic)
    tprep = tsynth.to_device(prep, "cpu")
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    key = "LOSS64" if f64 else "LOSS32"
    for i in range(n_steps):
        jloss = jsteps[i][0]
        tstate, tloss = tstep(tstate, tprep)
        assert sorted(tloss) == sorted(CRITERIA + ["loss"])
        for k in tloss:
            assert not tloss[k].requires_grad and tloss[k].dtype == dtype
            err = rel_err(jloss[k], tloss[k])
            assert err < BOUND[key], (k, i, err)
        if i == 0 and f64:
            for k, p in tm.named_parameters():
                err = rel_err(jgrad[k], p.grad)
                assert err < BOUND["GRAD64"], (k, err)
        elif i == 0:
            names = [k for k, _ in tm.named_parameters()]
            err = rel_err(torch.cat([jgrad[k].flatten() for k in names]),
                          torch.cat([p.grad.flatten() for _, p in tm.named_parameters()]))
            assert err < BOUND["GRAD32"], err
    assert tstate.step == n_steps and opt.count == n_steps
    if not f64:
        return
    jparams = jsteps[n_steps - 1][1]
    for k, p in tm.named_parameters():
        move_j = jparams[k].numpy() - before[k].numpy()
        move_t = (p.detach() - before[k]).numpy()
        assert np.abs(move_j).max() > 0, k
        err = rel_err(move_j, torch.as_tensor(move_t))
        assert err < BOUND["MOVE64"], (k, err)


# float64 forward, JAX against the port, relative to each output's scale:
# read on the CPU ~1e-9 for the waveform (mlp / physics), the JAX noise
# filter's complex64 inverse FFT; every other output ~1e-16
PREDS64, OUTPUTS64 = 1e-8, 1e-12


@pytest.mark.parametrize("estimator", ["mlp", "physics"])
def test_float64_forward_matches_jax(estimator, monkeypatch):
    """The float64 forward of both packages from the same weights, the
    noise fixed: every output within OUTPUTS64 but the waveform, which
    carries the JAX noise filter's complex64 rounding (PREDS64)."""
    jm, variables, tm, prep = jax_and_port(estimator, monkeypatch, torch.float64)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    jout = jsynth.forward_outputs(jm, variables, jprep, jax.random.key(0), jm.inharmonic)
    tout = tsynth.forward_outputs(tm, tsynth.to_device(prep, "cpu"), None, tm.inharmonic)
    assert sorted(jout) == sorted(tout)
    for k, v in tout.items():
        assert np.asarray(jout[k]).dtype == np.float64, k
        err = rel_err(np.asarray(jout[k]), v.detach())
        assert err < (PREDS64 if k == "preds" else OUTPUTS64), (k, err)


def test_physics_estimator_gradient_matches_jax():
    """The physics estimator's backward (linear solves, the stable
    argsort gather) reaches its inputs as the JAX package's does: the
    gradient of a weighted sum of its modes with respect to the pluck
    profile and the stiffness.  Read on the CPU: 2.0e-5 of scale; bound
    2e-4."""
    from torch_fdtd_string_tpu.models import physmodes as jphys
    from torch_fdtd_string_tpu_torch.models import physmodes as tphys

    prep = step_inputs(seed=2)
    u0, ka = prep["u_0"], prep["ka"][:, :, None]
    xg, gam = prep["xg"][:, :, None], np.full((3, 1, 1), 440.0, np.float32)
    t60 = prep["t60"]
    w = np.random.default_rng(5).standard_normal((2, 3, 8)).astype(np.float32)

    def jloss(u, k):
        amps, freqs = jphys.PhysicsModeEstimator(8, (0.01, 0.03)).apply(
            {}, u, jnp.asarray(xg), k, jnp.asarray(gam), jnp.asarray(t60))
        return jnp.sum(amps[:, 0] * w[0]) + 1e3 * jnp.sum(freqs[:, 0] * w[1])

    ju, jk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(ka))
    tu, tk = torch.as_tensor(u0).requires_grad_(), torch.as_tensor(ka).requires_grad_()
    amps, freqs = tphys.PhysicsModeEstimator(8, (0.01, 0.03))(
        tu, torch.as_tensor(xg), tk, torch.as_tensor(gam), torch.as_tensor(t60))
    (torch.sum(amps[:, 0] * torch.as_tensor(w[0]))
     + 1e3 * torch.sum(freqs[:, 0] * torch.as_tensor(w[1]))).backward()
    assert rel_err(ju, tu.grad) < 2e-4 and rel_err(jk, tk.grad) < 2e-4


def test_prelu_tie_takes_jax_subgradient():
    """At an input of exactly 0 the PReLU's gradient is JAX's
    (jnp.maximum / jnp.minimum split it: (1 + a) / 2), not torch.clamp's
    (1 + a)."""
    from torch_fdtd_string_tpu.models import blocks as jblocks
    from torch_fdtd_string_tpu_torch.models import blocks as tblocks

    x = np.zeros((2, 4), np.float32)
    jm = jblocks.MLP(4, 1)
    variables = flax_init(jm, jnp.asarray(x))  # zero bias: every unit sits on the tie
    jg = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x + 0.0))))(variables)
    tm = tblocks.MLP(4, 4, 1, None)
    load_jax_variables(tm, jax.tree.map(np.asarray, dict(variables)))
    xt = torch.zeros(2, 4, requires_grad=True)
    tm(xt).sum().backward()
    assert rel_err(jg["params"]["Dense_0"]["bias"], tm.layers[0].bias.grad) < 1e-6
    assert float(tm.layers[0].bias.grad[0]) == pytest.approx(2 * (1 + 0.25) / 2)


# ---- the mode protocol (twins of tests/test_mode_protocol.py) -------------------

def _tiny(amp_adaptive_noise=False, zero_first_item=False, B=2):
    """The JAX tests' tiny setup in the port: 16 kHz, 640 samples, 6
    modes, seeded weights."""
    sr, Nt, Nx, block, n_modes = 16000, 640, 256, 64, 6
    nf = Nt // block + 1
    model = tsyn.Synthesizer(n_modes=n_modes, n_bands=9, hidden_dim=16, embed_dim=8,
                             block_size=block, sr=sr, amp_adaptive_noise=amp_adaptive_noise,
                             generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    c_k = rng.normal(0, 0.01, (B, 1, n_modes))
    if zero_first_item:
        c_k[0] = 0.0
    u0 = np.zeros((B, 1, Nx))
    u0[:, 0, 40] = 0.01
    prep = {
        "xg": rng.uniform(0.2, 0.8, (B, 1)), "tg": np.tile(np.arange(Nt) / sr, (B, 1)),
        "ka": rng.uniform(0.01, 0.03, (B, 1)), "al": rng.uniform(1, 10, (B, 1)),
        "t60": np.tile([[[1000.0, 20.0], [100.0, 18.0]]], (B, 1, 1)),
        "f_k": np.cumsum(rng.uniform(0.01, 0.02, (B, 1, n_modes)), -1), "c_k": c_k,
        "f_0": rng.uniform(100, 400, (B, 1)).repeat(nf, 1), "u_0": u0,
        "gt": rng.normal(0, 0.01, (B, Nt)),
        "gt_f0": rng.uniform(0.01, 0.05, (B, 1)).repeat(nf, 1),
    }
    return model, {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in prep.items()}


def test_use_gt_modes_flag_switches_mode_source():
    model, prep = _tiny()
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    with torch.no_grad():
        out_gt = tsynth.forward_outputs(model, prep, gen(), use_gt_modes=True)
        out_est = tsynth.forward_outputs(model, prep, gen(), use_gt_modes=False)
        assert not torch.allclose(out_gt["preds"], out_est["preds"])
        ut, _, _ = model([prep[k] for k in KEYS[:5]] + [None, None], prep["f_0"], prep["u_0"],
                         gen())
    assert torch.equal(out_est["preds"], ut[..., :prep["gt"].shape[-1]])
    assert torch.equal(out_est["target_fk"], prep["f_k"])
    assert torch.equal(out_gt["target_fk"], prep["f_k"])


def test_eval_step_protocols_differ():
    model, prep = _tiny()
    registry = tregistry(model.sr, 48000)
    ev_gt = tsynth.make_eval_step(model, registry, ["l1", "magspec"], True, use_gt_modes=True)
    ev_est = tsynth.make_eval_step(model, registry, ["l1", "magspec"], True,
                                   use_gt_modes=False)
    _, ld_gt = ev_gt(prep, torch.Generator().manual_seed(3))
    _, ld_est = ev_est(prep, torch.Generator().manual_seed(3))
    assert float(ld_gt["loss"]) != float(ld_est["loss"])


# ---- the adaptive noise (twins of tests/test_adaptive_noise.py) -----------------

def test_zero_amplitude_item_keeps_gradients_finite(monkeypatch):
    """An item with all-zero mode amplitudes: finite loss and gradients in
    float32 (the eps under the envelope's sqrt, the detached envelope);
    in float64 the gradients equal the JAX package's from the same
    weights at the train-step bound GRAD64 (the float32 gradient is far
    from the float64 one, test_train_step_matches_jax)."""
    fix_noise(monkeypatch)
    monkeypatch.setattr(tsyn, "uniform", lambda shape, generator, device, dt: torch.as_tensor(
        np.random.default_rng(123).random(tuple(shape)).astype(np.float32), device=device).to(dt))
    _, prep = _tiny(True, True, B=3)
    kw = dict(n_modes=6, n_bands=9, hidden_dim=16, embed_dim=8, block_size=64, sr=16000,
              amp_adaptive_noise=True)
    jm = jsyn.Synthesizer(**kw)
    np_prep = {k: v.numpy() for k, v in prep.items()}
    variables = perturb(flax_init(jm, [jnp.asarray(np_prep[k]) for k in KEYS],
                                  jnp.asarray(np_prep["f_0"]), jnp.asarray(np_prep["u_0"])), 4)
    criteria = ["l1", "magspec", "f0", "modeamps"]
    registry = tregistry(16000, 16000)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = load_jax_variables(tsyn.Synthesizer(**kw), variables).to(dtype)
        out = tsynth.forward_outputs(model, {k: v.to(dtype) for k, v in prep.items()}, None,
                                     True, True)
        loss, _ = tsynth.compute_losses(out, registry, criteria)
        loss.backward()
        assert torch.isfinite(loss)
        # the estimator's frequency head feeds no criterion here: no
        # gradient in the port, zeros in the JAX package
        assert [k for k, p in model.named_parameters() if p.grad is None] == [
            k for k, _ in model.named_parameters() if k.startswith("estimator.freq_")]
        grads[dtype] = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                        for k, p in model.named_parameters()}
        for k, g in grads[dtype].items():
            assert torch.isfinite(g).all(), k
    v64 = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
    jprep = {k: jnp.asarray(v, jnp.float64) for k, v in np_prep.items()}

    def jloss(p):
        o = jsynth.forward_outputs(jm, {"params": p, "constants": v64["constants"]}, jprep,
                                   jax.random.key(3), True, True)
        return jsynth.compute_losses(o, jregistry(16000, 16000), criteria)[0]

    jgrad = port_params(model, jax.grad(jloss)(v64["params"]), v64["constants"])
    for k, g in grads[torch.float64].items():
        assert rel_err(jgrad[k], g) < BOUND["GRAD64"], (k, rel_err(jgrad[k], g))


def test_noise_level_scales_with_mode_amplitude():
    """The quiet (zero-amplitude) item gets a quieter noise floor."""
    model, prep = _tiny(True, True, B=3)
    with torch.no_grad():
        preds = tsynth.forward_outputs(model, prep, torch.Generator().manual_seed(3), True,
                                       True)["preds"]
    quiet = float(torch.sqrt((preds[0] ** 2).mean()))
    loud = float(torch.sqrt((preds[1:] ** 2).mean()))
    assert quiet < 0.2 * loud, (quiet, loud)


