"""The port resumes a run the JAX package trained.

The JAX package trains a small synthesizer (``SMALL``'s widths, the mlp
estimator) two steps in float64 and saves the run with its own
``tasks/trainer.py::save_checkpoint``: ``step_2/`` and its optax state in
``optstate_2/``.  The port's ``tasks/trainer.py::restore`` loads both, the
parameters and every moment bit for bit, and its third step on the same
batch meets the JAX package's third step; so does a resume of the run
``tools/convert_orbax.py`` converted, in a process state without
tensorstore.  Two chains: synth-dmsp's radam under noam, and adam under
the plateau rule, both behind the global-norm clip (whose empty state
orbax stores as no value).

The step runs the losses ``l1`` and ``modeamps`` (``dryrun_train_step``'s)
with the noise draw fixed at zero on both sides: the JAX package's float64
forward filters its noise in complex64 and its spectral losses round
differently (``tests/test_torch_dmsp_train_step.py`` holds the full
synth-dmsp criteria at its own bounds), and this test is about the state
the step continues from.  Readings on the CPU: parameters 1.7e-14 of each
tensor's scale, moments 3.6e-11 of the moment tree's scale (the noise
filter's weights, whose gradient the zero draw leaves at rounding level,
are 3.3e-8 of their own).  Bounds 1e-9.

Every optimizer the configs offer (sgd, adam, adamw, radam, lamb), under
the clip and the plateau rule, is then carried from an optax state that
two updates of given gradients left, and takes a third update as optax
does; LAMB and NovoGrad, whose rules are per layer, take each PReLU slope
(a flax leaf of its own) as a layer, as optax does.
"""

import functools
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_dmsp_modules import SMALL, perturb
from test_torch_dmsp_train_step import KEYS, port_params, step_inputs
from torch_fdtd_string_tpu.models import optim as joptim
from torch_fdtd_string_tpu.models import synthesizer as jsyn
from torch_fdtd_string_tpu.models.losses import build_loss_registry as jregistry
from torch_fdtd_string_tpu.tasks import synthesize as jsynth
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.models import optim as toptim
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables
from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry as tregistry
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.tools.convert_orbax import convert_run
from torch_fdtd_string_tpu_torch.utils.config import compose

SR, NT = 48000, 1024
CRITERIA = ["l1", "modeamps"]
MODEL = ["experiment=synth-dmsp", "model.mode_estimator=mlp", "task.grad_clip=[1.0]"] + [
    f"model.{k}={v}" for k, v in SMALL.items()]
CHAINS = {"radam-noam": [], "adam-plateau": ["optimizer=adam", "scheduler=plateau",
                                             "scheduler.patience=1"]}
BOUND = 1e-9


@functools.lru_cache(maxsize=None)
def jax_model():
    """The JAX synthesizer, its perturbed float64 variables and a float64
    batch of 3 items of 1024 samples."""
    prep = step_inputs()
    jm = jsyn.Synthesizer(**SMALL)
    init = jax.jit(lambda *a: jm.init({"params": jax.random.key(0),
                                       "noise": jax.random.key(1)}, *a))
    variables = perturb(init([jnp.asarray(prep[k]) for k in KEYS], jnp.asarray(prep["f_0"]),
                             jnp.asarray(prep["u_0"])), 3)
    variables = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
    return jm, variables, {k: v.astype(np.float64) for k, v in prep.items()}


def chain(args):
    """The optimizer config as both packages' ``build`` take it."""
    sched = args.get("scheduler")
    return (args.optimizer._name_, dict(args.optimizer), sched._name_, dict(sched),
            args.task.grad_clip[0])


def zero_noise(monkeypatch):
    """A uniform draw of 1/2 everywhere: the noise branch's ``2u - 1`` is 0."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None, **kw: jnp.full(shape, 0.5))
    monkeypatch.setattr(tsyn, "uniform", lambda shape, generator, device, dtype: torch.full(
        shape, 0.5, dtype=dtype, device=device))


def find(state, field):
    """The first ``field`` of an optax state tree."""
    if hasattr(state, "_fields"):
        if field in state._fields:
            return getattr(state, field)
        state = tuple(state)
    if isinstance(state, tuple):
        for s in state:
            got = find(s, field)
            if got is not None:
                return got
    return None


def tree_error(got, want):
    """Largest difference over the whole tree relative to its largest
    element, and per tensor relative to each tensor's."""
    diff = max(float((got[n] - want[n]).abs().max()) for n in want)
    scale = max(float(want[n].abs().max()) for n in want)
    per = max(float((got[n] - want[n]).abs().max() / want[n].abs().max().clamp_min(1e-300))
              for n in want)
    return diff / scale, per


def port_moments(tm, optimizer, key):
    return {n: optimizer.state[p][key] for n, p in tm.named_parameters()}


def jax_moments(tm, state, key, constants):
    return {k: torch.as_tensor(v) for k, v in port_params(tm, find(state, key),
                                                          constants).items()}


def port_side(args):
    """The port's float64 model and optimizer of the configuration."""
    tm = tsyn.Synthesizer(**SMALL).to(torch.float64)
    name, conf, sch, sch_conf, clip = chain(args)
    optimizer, _, needs_value = toptim.build(tm.parameters(), name, conf, sch, sch_conf, clip)
    return tm, optimizer, needs_value


def port_step(tm, optimizer, needs_value, prep):
    step = tsynth.make_train_step(tm, optimizer, tregistry(SR, NT), CRITERIA, tm.inharmonic,
                                  needs_value)
    state = tsynth.TrainState(tm, optimizer, 2, torch.Generator())
    _, losses = step(state, tsynth.to_device(prep, "cpu"))
    return {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("name", list(CHAINS))
def test_port_resumes_a_jax_run(name, tmp_path, monkeypatch):
    zero_noise(monkeypatch)
    jm, variables, prep = jax_model()
    over = MODEL + CHAINS[name]
    args = compose(trun.CONFIG_DIR, over)
    opt, conf, sch, sch_conf, clip = chain(args)
    tx, _, needs_value = joptim.build(opt, conf, sch, sch_conf, clip)
    params, constants = variables["params"], variables["constants"]
    jstate = jsynth.TrainState(params, {"constants": constants}, tx.init(params), 0,
                               jax.random.key(0))
    jstep = jsynth.make_train_step(jm, tx, jregistry(SR, NT), CRITERIA, jm.inharmonic,
                                   needs_value)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    for _ in range(2):
        jstate, _ = jstep(jstate, jprep)
    run = str(tmp_path / "jax_run")
    jtrainer.save_checkpoint(run, jstate, 2)
    jstate3, jloss3 = jstep(jstate, jprep)

    tm, optimizer, tneeds = port_side(args)
    assert tneeds == needs_value
    assert ttrainer.restore(run, tm, optimizer) == 2
    # the saved state, carried exactly
    assert optimizer.count == 2
    want = {k: torch.as_tensor(v) for k, v in port_params(tm, jstate.params, constants).items()}
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    for key in ("mu", "nu"):
        got, want = port_moments(tm, optimizer, key), jax_moments(tm, jstate.opt_state, key,
                                                                   constants)
        assert all(torch.equal(got[n], want[n]) for n in want), key
    if needs_value:
        plateau = jstate.opt_state[1][1]
        for k, v in optimizer.plateau.state.items():
            assert float(v) == float(getattr(plateau, k)), k

    # the third step, against the JAX package's
    losses = port_step(tm, optimizer, tneeds, prep)
    for k, v in losses.items():
        assert abs(v - float(jloss3[k])) <= BOUND * abs(float(jloss3[k])), k
    got = {n: p.detach() for n, p in tm.named_parameters()}
    want = {k: torch.as_tensor(v) for k, v in port_params(tm, jstate3.params, constants).items()}
    assert tree_error(got, want)[1] < BOUND
    for key in ("mu", "nu"):
        err = tree_error(port_moments(tm, optimizer, key),
                         jax_moments(tm, jstate3.opt_state, key, constants))[0]
        assert err < BOUND, (key, err)
    assert optimizer.count == 3

    # the converted run resumes without tensorstore, to the same step
    out = str(tmp_path / "converted")
    convert_run(run, out, over)
    tm2, optimizer2, _ = port_side(args)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    assert ttrainer.restore(out, tm2, optimizer2) == 2
    assert port_step(tm2, optimizer2, tneeds, prep) == losses
    for (n, p), (_, q) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(p, q), n
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(
            port_moments(tm, optimizer, key).values(),
            port_moments(tm2, optimizer2, key).values())), key


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "radam", "lamb"])
def test_every_configured_optimizer_carries_over(opt, tmp_path):
    """An optax state of clip -> ``opt`` -> plateau after two updates of
    given gradients, saved by the JAX package, restored into the port's
    optimizer and updated once more with the same gradient and loss as
    optax is: parameters and each state tensor at 1e-12 of scale."""
    _, variables, _ = jax_model()
    params, constants = variables["params"], variables["constants"]
    args = compose(trun.CONFIG_DIR, MODEL + [f"optimizer={opt}", "scheduler=plateau",
                                            "scheduler.patience=1"])
    name, conf, sch, sch_conf, clip = chain(args)
    tx, _, _ = joptim.build(name, conf, sch, sch_conf, clip)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda x: rng.normal(0.0, 0.3, np.shape(x)), params)
             for _ in range(3)]
    values = [2.0, 2.0, 1.5]  # the second update meets a plateau of patience 1
    state = tx.init(params)
    for g, v in zip(grads[:2], values[:2]):
        updates, state = tx.update(g, state, params, value=v)
        params = optax.apply_updates(params, updates)
    run = str(tmp_path / "run")
    jtrainer.save_checkpoint(run, SimpleNamespace(params=params, constants={
        "constants": constants}, opt_state=state), 2)
    updates, state3 = tx.update(grads[2], state, params, value=values[2])
    params3 = optax.apply_updates(params, updates)

    tm, optimizer, _ = port_side(args)
    assert ttrainer.restore(run, tm, optimizer) == 2
    assert float(optimizer.plateau.state["scale"]) == float(state[1][1].scale) < 1.0
    for n, g in port_params(tm, grads[2], constants).items():
        dict(tm.named_parameters())[n].grad = torch.as_tensor(g)
    optimizer.step(value=torch.tensor(values[2], dtype=torch.float64))
    got = {n: p.detach() for n, p in tm.named_parameters()}
    want = {k: torch.as_tensor(v) for k, v in port_params(tm, params3, constants).items()}
    assert tree_error(got, want)[1] < 1e-12
    for key in ("mu", "nu", "trace"):
        if find(state3, key) is not None:
            assert tree_error(port_moments(tm, optimizer, key),
                              jax_moments(tm, state3, key, constants))[1] < 1e-12, key
    assert float(optimizer.plateau.state["scale"]) == float(state3[1][1].scale)


@pytest.mark.parametrize("opt", ["lamb", "novograd"])
def test_layerwise_rules_take_each_prelu_slope(opt):
    """Three updates of given gradients from the JAX variables, optax's and
    the port's, at 1e-12 of each parameter's scale: the port stacks each
    MLP's PReLU slopes in one parameter (``stacked_leaves``), and LAMB's
    trust ratio and NovoGrad's second moment take each slope alone."""
    _, variables, _ = jax_model()
    params, constants = variables["params"], variables["constants"]
    tx, _, _ = joptim.build(opt, {"lr": 1e-3}, None, {})
    tm = load_jax_variables(tsyn.Synthesizer(**SMALL).to(torch.float64), variables)
    optimizer = toptim.build(tm.parameters(), opt, {"lr": 1e-3}, None, {})[0]
    rng = np.random.default_rng(6)
    state = tx.init(params)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.normal(0.0, 0.3, np.shape(x)), params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        for n, gn in port_params(tm, g, constants).items():
            dict(tm.named_parameters())[n].grad = torch.as_tensor(gn)
        optimizer.step()
    got = {n: p.detach() for n, p in tm.named_parameters()}
    want = {k: torch.as_tensor(v) for k, v in port_params(tm, params, constants).items()}
    assert tree_error(got, want)[1] < 1e-12
