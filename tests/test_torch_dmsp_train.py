"""DMSP training in the port against the JAX package's.

The train step (``tasks/synthesize.py::make_train_step``) at the JAX
tests' small widths, one and three steps, both estimators, against JAX
``make_train_step``: the flax variables carried into the port by
``models/convert.py``, the same function mapping the flax gradient tree
onto the port's parameter names, the noise draw fixed on both sides.
Then ``proc.train`` end to end through ``run.main`` on a corpus the port
generates, against JAX ``trainer.train`` from the same initial weights;
the resume, the checkpoints with optimizer state, ``BEST``, the device
cache and the streaming path, the eval sweep's out-of-memory backoff, the
code snapshot, the mode protocol and the adaptive noise.  float32 on both
sides (the JAX package with x64 on, tests/conftest.py).
"""

import glob
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import SMALL, fix_noise, flax_init, perturb, rel_err, synth_inputs
from torch_fdtd_string_tpu.data import dataset as jdata
from torch_fdtd_string_tpu.models import optim as joptim
from torch_fdtd_string_tpu.models import synthesizer as jsyn
from torch_fdtd_string_tpu.models.losses import build_loss_registry as jregistry
from torch_fdtd_string_tpu.tasks import synthesize as jsynth
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.core import analytic as tanalytic
from torch_fdtd_string_tpu_torch.data import dataset as tdata
from torch_fdtd_string_tpu_torch.models import optim as toptim
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables, state_dict_from_jax
from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry as tregistry
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")
SR = 48000
CRITERIA = ["l1", "magspec", "melspec", "f0", "modefreq", "modeamps"]  # synth-dmsp's
KEYS = ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")
# six plucked strings of 50 ms, four kept pickup columns each: 4 train
# strings (16 items, 2 steps of 8 per epoch), 1 valid, 1 test
CORPUS = ["experiment=nsynth-like", "task.num_samples=6", "task.batch_size=6",
          "task.length=0.05", "task.chunk_length=0.05", "task.save_x_stride=16",
          "task.process_Nx=64", "task.save=false", "task.save_output_wav=false",
          "proc.cpu=true"]
NAME = "corpus-prep"
TRAIN = ["experiment=synth-dmsp", "proc.train=true", "proc.test=true", "task.plot=false",
         f"task.load_name={NAME}", "task.batch_size=8", "task.valid_batch_size=8",
         "task.test_batch_size=8", "task.total_epoch=1", "proc.cpu=true"] + [
         f"model.{k}={v}" for k, v in SMALL.items()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's fused corpus split by the port's make_splits; returns
    the load_dir."""
    root = tmp_path_factory.mktemp("dmsp_train_corpus")
    tsim.run(tcompose(CONFIG_DIR, CORPUS), str(root / "corpus"), "pluck", 1)
    assert make_splits(str(root / NAME), valid_n=1, test_n=1) == {
        "train": 4, "valid": 1, "test": 1}
    return str(root)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("estimator", ["mlp", "physics"])
def test_train_step_matches_jax(estimator, n_steps, dtype, monkeypatch):
    jm, variables, tm, prep = jax_and_port(estimator, monkeypatch, dtype)
    params, constants = variables["params"], variables["constants"]
    jreg, treg = jregistry(SR, SR), tregistry(SR, SR)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    f64 = dtype == torch.float64

    # the gradient of the first step, in the JAX train step's own loss
    def loss_fn(p):
        out = jsynth.forward_outputs(jm, {"params": p, "constants": constants}, jprep,
                                     jax.random.key(0), jm.inharmonic)
        return jsynth.compute_losses(out, jreg, CRITERIA)[0]

    jgrad = port_params(tm, jax.grad(loss_fn)(params), constants)

    sch = ("noam", {"warmup_steps": 1000})  # synth-dmsp's optimizer and schedule
    tx, _, _ = joptim.build("radam", {"lr": 1e-3}, *sch)
    jstate = jsynth.TrainState(params, {"constants": constants}, tx.init(params), 0,
                               jax.random.key(0))
    jstep = jsynth.make_train_step(jm, tx, jreg, CRITERIA, jm.inharmonic)
    opt, _, _ = toptim.build(tm.parameters(), "radam", {"lr": 1e-3}, *sch)
    tstate = tsynth.TrainState(tm, opt, 0, torch.Generator())
    tstep = tsynth.make_train_step(tm, opt, treg, CRITERIA, tm.inharmonic)
    tprep = tsynth.to_device(prep, "cpu")
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    key = "LOSS64" if f64 else "LOSS32"
    for i in range(n_steps):
        jstate, jloss = jstep(jstate, jprep)
        tstate, tloss = tstep(tstate, tprep)
        assert sorted(tloss) == sorted(CRITERIA + ["loss"])
        for k in tloss:
            assert not tloss[k].requires_grad and tloss[k].dtype == dtype
            err = rel_err(np.asarray(jloss[k]), tloss[k])
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
    jparams = port_params(tm, jstate.params, constants)
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


# ---- proc.train end to end -------------------------------------------------------

# the first epoch's valid/loss of the port against JAX trainer.train from
# the same initial weights and fixed noise: read on the CPU 2.0e-6
# relative (the float32 phase sums); bound 2e-5
VALID_LOSS_BOUND = 2e-5


def test_proc_train_matches_jax_train(corpus, tmp_path, monkeypatch):
    """Twin of test_trainer.py::test_train_evaluate_resume through the
    port's run.main: the step count, profile.json, metrics.jsonl's keys,
    the checkpoints with optimizer state, BEST, the score tables, then a
    resume that continues the step; the first epoch's valid/loss against
    JAX trainer.train's."""
    fix_noise(monkeypatch)
    over = TRAIN + [f"task.load_dir={corpus}"]

    # the JAX package trains first, from its own initial weights, on one
    # device (no mesh); the port starts from the same weights
    captured = {}
    init_state = jtrainer._init_state

    def capture(*a, **kw):
        captured["state"] = init_state(*a, **kw)
        return captured["state"]

    monkeypatch.setattr(jtrainer, "_init_state", capture)
    monkeypatch.setenv("FDTD_NO_MESH", "1")
    jargs = jcompose(CONFIG_DIR, [o for o in over if o != "proc.train=true"])
    jax_dir = str(tmp_path / "jax")
    os.makedirs(jax_dir)
    jtrainer.train(jargs, jax_dir)
    jrec = [json.loads(line) for line in open(os.path.join(jax_dir, "metrics.jsonl"))]
    st = captured["state"]
    variables = {"params": jax.tree.map(np.asarray, st.params),
                 "constants": jax.tree.map(np.asarray, st.constants["constants"])}
    build_model = tsynth.build_model

    def from_jax(*a, **kw):
        return load_jax_variables(build_model(*a, **kw), variables)

    monkeypatch.setattr(tsynth, "build_model", from_jax)
    save_dir = trun.main(over + [f"task.root_dir={tmp_path}", "task.save_name=port"])
    monkeypatch.setattr(tsynth, "build_model", build_model)

    n_train, bs = 4 * 4, 8
    spe = n_train // bs
    recs = [json.loads(line) for line in open(os.path.join(save_dir, "metrics.jsonl"))]
    valid = [r for r in recs if r.get("split") == "valid"]
    tests = [r for r in recs if r.get("split") == "test"]
    assert [r["step"] for r in valid] == [spe]
    jvalid = [r for r in jrec if r.get("split") == "valid"][0]
    assert sorted(valid[0]) == sorted(jvalid)
    assert valid[0]["lr"] == toptim.get_schedule("noam", 1e-3, {"warmup_steps": 1000})(spe)
    err = abs(valid[0]["valid/loss"] - jvalid["valid/loss"]) / abs(jvalid["valid/loss"])
    assert err < VALID_LOSS_BOUND, (valid[0]["valid/loss"], jvalid["valid/loss"])
    # the test split's record of the epoch, and the final scoring's
    assert "test/loss" in tests[0] and "test/sisdr" in tests[-1]
    assert all(np.isfinite(v) for r in valid + tests for v in r.values()
               if isinstance(v, float))
    prof = json.load(open(os.path.join(save_dir, "profile.json")))
    assert prof["train_step"]["count"] == spe and prof["device_cache"]["count"] == 3
    ckdir = ttrainer._ckpt_dir(save_dir)
    assert sorted(os.listdir(ckdir)) == ["BEST", f"optstate_{spe}.pt", f"step_{spe}.pt"]
    assert open(os.path.join(ckdir, "BEST")).read().split()[0] == str(spe)
    opt = torch.load(os.path.join(ckdir, f"optstate_{spe}.pt"), weights_only=True)
    assert opt["param_groups"][0]["count"] == spe
    assert os.path.isfile(os.path.join(save_dir, "config_tree.txt"))
    assert os.path.isfile(os.path.join(save_dir, "codes", "torch_fdtd_string_tpu_torch",
                                       "tasks", "trainer.py"))
    # the snapshot's scoring found the checkout's physics tables: it built
    # no cache of its own in the run directory
    assert not os.path.exists(os.path.join(save_dir, "codes", "build"))
    for name in ("output", "modals"):
        lines = open(os.path.join(save_dir, "score", f"{name}.txt")).read().strip().split("\n")
        assert lines[0].split("\t") == ["id"] + ttrainer.HEADER and len(lines) == 2 + 4
        assert lines[-1].startswith("# mean")
    # the snapshot's modules were put back: the live trainer is imported
    assert sys.modules["torch_fdtd_string_tpu_torch.tasks.trainer"] is ttrainer

    # resume: one more epoch continues the step and the optimizer's count
    save_dir2 = trun.main(over + [f"task.root_dir={tmp_path}", "task.save_name=port",
                                  "task.total_epoch=2", "task.resume=true", "proc.test=false"])
    assert save_dir2 == save_dir
    recs = [json.loads(line) for line in open(os.path.join(save_dir, "metrics.jsonl"))]
    assert [r["step"] for r in recs if r.get("split") == "valid"] == [spe, 2 * spe]
    opt = torch.load(os.path.join(ckdir, f"optstate_{2 * spe}.pt"), weights_only=True)
    assert opt["param_groups"][0]["count"] == 2 * spe


def test_resume_restores_optimizer_exactly(corpus, tmp_path):
    """The optimizer state loaded on resume equals the saved one, tensor
    for tensor; without an optstate file the count is fast-forwarded to
    the step (the moments start at zero)."""
    over = TRAIN + [f"task.load_dir={corpus}", "proc.test=false"]
    args = tcompose(CONFIG_DIR, over)
    save_dir = str(tmp_path / "run")
    state = ttrainer.train(args, save_dir)
    saved = state.optimizer.state_dict()
    model = tsynth.build_model(args, torch.Generator().manual_seed(99))
    opt, schedule, _ = toptim.build(model.parameters(), "radam", {"lr": 1e-3}, "noam",
                                    {"warmup_steps": 1000})
    step = ttrainer.restore(save_dir, model, opt)
    assert step == state.step == opt.count and opt.lr() == schedule(step)
    got = opt.state_dict()
    assert got["param_groups"] == saved["param_groups"]
    for i, s in saved["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    os.remove(os.path.join(ttrainer._ckpt_dir(save_dir), f"optstate_{step}.pt"))
    opt2, _, _ = toptim.build(model.parameters(), "radam", {"lr": 1e-3}, "noam",
                              {"warmup_steps": 1000})
    assert ttrainer.restore(save_dir, model, opt2) == step
    assert opt2.count == step and not opt2.state


def test_streaming_path_and_prefetch(corpus, tmp_path, monkeypatch):
    """A device-cache budget of 0 streams every batch through _prefetch:
    the same step count, no device cache; a worker's exception reaches the
    loop."""
    args = tcompose(CONFIG_DIR, TRAIN + [f"task.load_dir={corpus}", "proc.test=false"])
    save_dir = str(tmp_path / "stream")
    monkeypatch.setattr(ttrainer, "CACHE_GB", 0.0)
    state = ttrainer.train(args, save_dir)
    assert state.step == 2
    prof = json.load(open(os.path.join(save_dir, "profile.json")))
    assert "device_cache" not in prof and prof["valid_sweep"]["count"] == 1
    recs = [json.loads(line) for line in open(os.path.join(save_dir, "metrics.jsonl"))]
    assert {r["split"] for r in recs} == {"valid", "test"}

    def broken():
        yield {"x": np.zeros(3, np.float32)}
        raise OSError("disk gone")

    it = ttrainer._prefetch(broken(), torch.device("cpu"))
    assert torch.equal(next(it)["x"], torch.zeros(3))
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_device_cache_f16_gather(corpus):
    """Twin of test_trainer.py::test_device_cache_f16_gather: the f16
    cache's waveforms upcast in the gather within 2e-3 of scale, the other
    fields exact; the f32 gather equals the JAX package's, field for
    field; the host cache file, and a stale one rebuilt."""
    ts = tdata.Trainset(corpus, NAME)
    dev = torch.device("cpu")
    path = os.path.join(corpus, NAME, "_prep_train_test.npz")
    g32, n = ttrainer._device_cache(ts, 8, 64, SR, dev, drop=("analytic",), cache_path=path)
    g16, n2 = ttrainer._device_cache(ts, 8, 64, SR, dev, drop=("analytic",), f16=True)
    assert n == n2 == 16 and os.path.exists(path) and g32.nbytes > g16.nbytes
    idx = np.array([3, 0, 9, 15])
    b32 = {k: v.numpy() for k, v in g32(idx).items()}
    b16 = {k: v.numpy() for k, v in g16(idx).items()}
    assert set(b32) == set(b16) and "analytic" not in b32
    for k in b32:
        assert b16[k].dtype == b32[k].dtype and b32[k].shape[0] == 4, k
        scale = max(1e-3, float(np.abs(b32[k]).max()))
        assert np.max(np.abs(b32[k] - b16[k])) <= 2e-3 * scale, k
    jg, _ = jtrainer._device_cache(jdata.Trainset(corpus, NAME), 8, 64, SR, drop=("analytic",))
    jb = jg(idx)
    assert set(jb) == set(b32)
    for k in b32:
        np.testing.assert_array_equal(np.asarray(jb[k]), b32[k], k)
    # a cache of fewer rows than the dataset is rebuilt, not gathered from
    np.savez(path, **{k: v[:3] for k, v in b32.items()})
    g, _ = ttrainer._device_cache(ts, 8, 64, SR, dev, drop=("analytic",), cache_path=path)
    with np.load(path) as z:
        assert z["gt"].shape[0] == 16
    np.testing.assert_array_equal(g(idx)["gt"].numpy(), b32["gt"])


def test_eval_sweep_oom_backoff():
    """Twin of test_trainer.py::test_eval_sweep_oom_backoff: the sweep
    halves its batch on torch.cuda.OutOfMemoryError and re-runs whole at
    the working size; any other error propagates."""
    calls = []

    def gather(idx):
        return np.asarray(idx)

    def eval_fn(prep, generator):
        calls.append(len(prep))
        if len(prep) > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return {"n": len(prep)}, {"loss": float(len(prep))}

    firsts = []
    vals, bs = ttrainer._eval_sweep(eval_fn, gather, n_items=10, bs=16, seed=0,
                                    device="cpu", on_first=lambda o: firsts.append(o["n"]))
    assert bs == 4
    assert calls == [10, 8, 4, 4, 2]
    assert [v["loss"] for v in vals] == [4.0, 4.0, 2.0] and [v["_n"] for v in vals] == [4, 4, 2]
    assert firsts[-1] == 4

    def eval_bad(prep, generator):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal"):
        ttrainer._eval_sweep(eval_bad, gather, n_items=4, bs=2, seed=0, device="cpu")


def test_proc_train_needs_a_card_or_proc_cpu(tmp_path, monkeypatch, corpus):
    """proc.train without a card and without proc.cpu=true raises; with
    task.plot=true it refuses (plots are not ported); with task.ckpt_dir
    it refuses to score another run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = [o for o in TRAIN if o != "proc.cpu=true"] + [f"task.load_dir={corpus}",
                                                         f"task.root_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        trun.main(over + ["task.save_name=nocard"])
    with pytest.raises(NotImplementedError, match="task.plot"):
        trun.main(over + ["task.save_name=plot", "task.plot=true", "proc.cpu=true"])
    with pytest.raises(ValueError, match="ckpt_dir"):
        trun.main(over + ["task.save_name=ck", "proc.cpu=true", "task.total_epoch=0",
                          f"task.ckpt_dir={tmp_path}"])


# ---- the code snapshot (twins of tests/test_snapshot_code.py) -----------------------

def test_backup_code_snapshot_excludes(tmp_path):
    src = tmp_path / "pkg"
    (src / "data").mkdir(parents=True)
    (src / "mod.py").write_text("X = 1\n")
    (src / "data" / "dataset.py").write_text("Y = 2\n")
    (src / "__pycache__").mkdir()
    (src / "__pycache__" / "mod.cpython-312.pyc").write_text("junk")
    (src / "build").mkdir()
    (src / "build" / "lib.so").write_bytes(b"\x00")
    (src / "weights.npz").write_bytes(b"\x00")
    (src / "kernel.cu").write_text("// source\n")
    trun.backup_code(str(src), str(tmp_path / "run"))
    codes = tmp_path / "run" / "codes" / "pkg"
    assert (codes / "mod.py").read_text() == "X = 1\n"
    assert (codes / "data" / "dataset.py").read_text() == "Y = 2\n"
    assert (codes / "kernel.cu").exists()
    assert not (codes / "__pycache__").exists() and not (codes / "build").exists()
    assert not (codes / "weights.npz").exists()


def _keep_modules():
    return list(sys.path), {k: v for k, v in sys.modules.items() if ttrainer._in_pkg(k)}


def _put_back(saved_path, saved):
    sys.path[:] = saved_path
    for k in [m for m in sys.modules if ttrainer._in_pkg(m)]:
        del sys.modules[k]
    sys.modules.update(saved)


def test_use_snapshot_code_executes_snapshot(tmp_path):
    """The snapshot's package is imported, and a second call does not grow
    sys.path."""
    codes = tmp_path / "codes" / "torch_fdtd_string_tpu_torch"
    codes.mkdir(parents=True)
    (codes / "__init__.py").write_text("SNAPSHOT_SENTINEL = 'snap'\n")
    saved = _keep_modules()
    try:
        assert ttrainer.use_snapshot_code(str(tmp_path)) is True
        n = len(sys.path)
        assert ttrainer.use_snapshot_code(str(tmp_path)) is True and len(sys.path) == n
        import torch_fdtd_string_tpu_torch as pkg

        assert getattr(pkg, "SNAPSHOT_SENTINEL", None) == "snap"
        assert os.path.dirname(pkg.__file__) == str(codes)
    finally:
        _put_back(*saved)


def test_use_snapshot_code_noop_without_snapshot(tmp_path):
    saved_path = list(sys.path)
    assert ttrainer.use_snapshot_code(str(tmp_path)) is False
    assert sys.path == saved_path


def test_evaluate_delegates_to_snapshot_generation(tmp_path):
    """With a snapshot, evaluate() runs the snapshot's evaluate with the
    checkout's cache directory; afterwards the live modules and sys.path
    are back."""
    codes = tmp_path / "codes" / "torch_fdtd_string_tpu_torch"
    (codes / "tasks").mkdir(parents=True)
    (codes / "__init__.py").write_text("")
    (codes / "tasks" / "__init__.py").write_text("")
    (codes / "core").mkdir()
    (codes / "core" / "__init__.py").write_text("")
    (codes / "core" / "analytic.py").write_text("CACHE_DIR = 'snapshot cache'\n")
    (codes / "tasks" / "trainer.py").write_text(
        "import os\n"
        "from ..core import analytic\n"
        "def evaluate(args, save_dir):\n"
        "    open(os.path.join(save_dir, 'SNAPSHOT_EVAL_MARKER'), 'w').write('ran')\n"
        "    return 'snapshot-generation', analytic.CACHE_DIR\n")
    args = SimpleNamespace(task=SimpleNamespace(ckpt_dir=str(tmp_path)))
    saved = _keep_modules()
    try:
        # the snapshot reads the checkout's root tables, not its own cache
        assert ttrainer.evaluate(args, str(tmp_path)) == ("snapshot-generation",
                                                           tanalytic.CACHE_DIR)
        assert (tmp_path / "SNAPSHOT_EVAL_MARKER").read_text() == "ran"
        assert sys.path == saved[0]
        assert sys.modules["torch_fdtd_string_tpu_torch.tasks.trainer"] is ttrainer
    finally:
        _put_back(*saved)


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


def test_checkpoint_files_are_written_whole(tmp_path, monkeypatch):
    """save_checkpoint leaves no temporary file, and a failed write leaves
    no file of its step."""
    args = tcompose(CONFIG_DIR, TRAIN)
    model = tsynth.build_model(args, torch.Generator().manual_seed(1))
    opt, _, _ = toptim.build(model.parameters(), "radam", {"lr": 1e-3}, "noam", {})
    ttrainer.save_checkpoint(str(tmp_path), model, 7, opt)
    assert sorted(os.listdir(ttrainer._ckpt_dir(str(tmp_path)))) == ["optstate_7.pt",
                                                                     "step_7.pt"]

    def fail(obj, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    with pytest.raises(OSError):
        ttrainer.save_checkpoint(str(tmp_path), model, 8, opt)
    assert not glob.glob(os.path.join(ttrainer._ckpt_dir(str(tmp_path)), "*_8.pt*"))


def test_profiling_scopes_and_trace(tmp_path):
    """utils/profiling.py: Timer's scopes and its profile.json summary (the
    JAX package's format)."""
    from torch_fdtd_string_tpu.utils import profiling as jprof
    from torch_fdtd_string_tpu_torch.utils import profiling as tprof

    timers = [jprof.Timer(), tprof.Timer()]
    for t in timers:
        for _ in range(3):
            with t.scope("train_step"):
                pass
        with t.scope("train_epoch"):
            pass
    summaries = [t.summary() for t in timers]
    assert [sorted(s) for s in summaries] == [["train_epoch", "train_step"]] * 2
    for s in summaries:
        assert s["train_step"]["count"] == 3 and sorted(s["train_step"]) == [
            "count", "mean_s", "total_s"]
    path = timers[1].dump(str(tmp_path / "profile.json"))
    assert json.load(open(path))["train_epoch"]["count"] == 1
