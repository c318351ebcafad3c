"""The port's optimizers and schedules against optax, in float64.

The same seeded parameters and gradient sequence (elements of sizes 1e-9
to 1) go through the JAX package's ``models/optim.py::build`` (optax
0.2.6) and the port's; the parameters' movement after every step is held
at 1e-12 of the JAX movement's scale.  Readings on the CPU: at most
6.9e-15 (adamw; radam 3.4e-15, sgd and lamb 0), while
``torch.optim.RAdam`` misses by more than 1e3 times the bound (its eps
sits before the second moment's bias correction, and it rectifies at
rho > 5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.models import optim as joptim
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu_torch.models import optim as toptim

REL = 1e-12
SHAPES = {"w": (5, 4), "b": (10,), "k": (3, 2, 2), "g": (8,)}  # 50 parameters
# each optimizer under a schedule whose transitions fall within the steps,
# among those optax evaluates in float64 at its int32 count (see
# test_schedule_matches_optax)
CASES = {
    "sgd": ({"lr": 4e-4, "momentum": 0.9}, "multistep", {"milestones": [4, 8], "gamma": 0.5}),
    "adam": ({"lr": 2e-4, "betas": (0.9, 0.999)}, "cosine", {"T_max": 10, "eta_min": 1e-6}),
    "adamw": ({"lr": 4e-4, "weight_decay": 1e-3}, "noam", {"warmup_steps": 4}),
    "radam": ({"lr": 1e-3}, "noam", {"warmup_steps": 5}),
    "lamb": ({"lr": 4e-4, "weight_decay": 1e-2}, "multistep",
             {"milestones": [3, 7], "gamma": 0.2}),
    "novograd": ({"lr": 1e-3}, "cosine", {"T_max": 8, "eta_min": 1e-5}),
}


def init_params(seed=0):
    """Parameters of size ~1e-2: their float64 ulp stays far below the
    bound times the movement of a few steps."""
    rng = np.random.default_rng(seed)
    return {k: 1e-2 * rng.standard_normal(s) for k, s in SHAPES.items()}


def grad_sequence(n, seed=1):
    """``n`` gradient dicts, every element of size 1e-9..1 with a random
    sign."""
    rng = np.random.default_rng(seed)
    return [{k: rng.choice([-1.0, 1.0], s) * 10.0 ** rng.uniform(-9, 0, s)
             for k, s in SHAPES.items()} for _ in range(n)]


def jax_run(name, conf, sch, sch_conf, grads, grad_clip=None, values=None, scales=None):
    """Parameters after each optax update; with ``scales`` a list, the
    plateau rule's scale after each update is appended to it."""
    tx, _, needs_value = joptim.build(name, dict(conf), sch, dict(sch_conf), grad_clip)
    params = {k: jnp.asarray(v) for k, v in init_params().items()}
    state = tx.init(params)
    out = []
    for i, g in enumerate(grads):
        kw = {"value": jnp.asarray(values[i])} if needs_value else {}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params, **kw)
        params = {k: params[k] + upd[k] for k in params}
        out.append({k: np.asarray(v) for k, v in params.items()})
        if scales is not None:
            scales.append(float(state[1].scale))  # chain(tx, reduce_on_plateau)
    return out


def port_setup(name, conf, sch, sch_conf, grad_clip=None):
    params = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in init_params().items()}
    opt, schedule, needs_value = toptim.build(params.values(), name, dict(conf), sch,
                                              dict(sch_conf), grad_clip)
    return params, opt, schedule, needs_value


def port_step(params, opt, g, value=None):
    for k, p in params.items():
        p.grad = torch.as_tensor(g[k])
    opt.step(value=None if value is None else torch.tensor(value, dtype=torch.float64))


def port_run(name, conf, sch, sch_conf, grads, grad_clip=None, values=None):
    params, opt, _, needs_value = port_setup(name, conf, sch, sch_conf, grad_clip)
    out = []
    for i, g in enumerate(grads):
        port_step(params, opt, g, values[i] if needs_value else None)
        out.append({k: p.detach().numpy().copy() for k, p in params.items()})
    return out


def movement_err(want, got):
    """Largest difference of the parameters' movement from the start, over
    every step and leaf, relative to the JAX movement's largest."""
    p0 = init_params()
    scale = max(np.abs(w[k] - p0[k]).max() for w in want for k in w)
    err = max(np.abs(w[k] - g[k]).max() for w, g in zip(want, got) for k in w)
    return err / scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_optax(name):
    conf, sch, sch_conf = CASES[name]
    grads = grad_sequence(12)
    want = jax_run(name, conf, sch, sch_conf, grads)
    got = port_run(name, conf, sch, sch_conf, grads)
    assert got[0]["w"].dtype == np.float64
    assert movement_err(want, got) <= REL, movement_err(want, got)


def test_torch_radam_is_not_optax_radam():
    """Why RAdam is written by hand: ``torch.optim.RAdam`` on the same
    sequence at a constant learning rate misses optax's by far more than
    the bound."""
    grads = grad_sequence(12)
    want = jax_run("radam", {"lr": 1e-3}, "constant", {}, grads)
    params = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in init_params().items()}
    opt = torch.optim.RAdam(params.values(), lr=1e-3)
    got = []
    for g in grads:
        for k, p in params.items():
            p.grad = torch.as_tensor(g[k])
        opt.step()
        got.append({k: p.detach().numpy().copy() for k, p in params.items()})
    assert movement_err(want, got) > 1e3 * REL
    assert movement_err(want, port_run("radam", {"lr": 1e-3}, "constant", {}, grads)) <= REL


SCHEDULES = {
    "constant": {},
    "noam": {"warmup_steps": 7},
    "step": {"step_size": 5, "gamma": 0.9},
    "multistep": {"milestones": [4, 11, 30], "gamma": 0.2},
    "cosine": {"T_max": 25, "eta_min": 1e-6},
    "cosine_warmup": {"num_warmup_steps": 6, "num_training_steps": 30},
    "linear_warmup": {"num_warmup_steps": 6, "num_training_steps": 30},
    "constant_warmup": {"num_warmup_steps": 6},
    "plateau": {"factor": 0.2, "patience": 20, "min_lr": 0.0},
    "timm_cosine": {"t_initial": 300},
}


# optax divides its int32 count by an int in linear_schedule and
# exponential_decay, which JAX does in float32 even with x64 on: at optax's
# own count these schedules are float32-rounded (read on the CPU: at most
# 9.2e-8 of base_lr off the float64 formula; bound 2.5e-7), the others
# float64
F32_AT_INT_COUNT = {"step", "cosine_warmup", "linear_warmup", "constant_warmup"}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    """Each schedule at counts 0..40 against the JAX package's, evaluated
    by optax in float64 (a float64 count): 1e-12 of base_lr; at optax's
    int32 count, within float32 rounding where optax rounds."""
    base = 1e-3
    jsch = joptim.get_schedule(name, base, SCHEDULES[name], total_steps=40)
    tsch = toptim.get_schedule(name, base, SCHEDULES[name], total_steps=40)
    for count in range(41):
        got = tsch(count)
        assert isinstance(got, float)
        want = float(np.asarray(jsch(jnp.asarray(count, jnp.float64))))
        assert abs(got - want) <= REL * base, (count, want, got)
        want32 = float(np.asarray(jsch(jnp.asarray(count, jnp.int32))))
        tol = 2.5e-7 * base if name in F32_AT_INT_COUNT else REL * base
        assert abs(got - want32) <= tol, (count, want32, got)


def test_schedule_real_horizon():
    """Twin of test_trainer.py::test_schedule_real_horizon: the cosine and
    warm-up schedules decay over the run's real length."""
    total = 1234
    p = [torch.nn.Parameter(torch.zeros(2))]
    _, sch, _ = toptim.build(p, "adam", {"lr": 1e-3}, "cosine", {}, None, total_steps=total)
    assert sch(0) == pytest.approx(1e-3)
    assert sch(total) == pytest.approx(1e-6, rel=0.01)
    _, sch2, _ = toptim.build(p, "adam", {"lr": 1e-3}, "linear_warmup",
                              {"num_warmup_steps": 100}, None, total_steps=total)
    assert sch2(100) == pytest.approx(1e-3)
    assert sch2(total) == pytest.approx(0.0, abs=2e-5)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "below"])
def test_global_norm_clip_matches_optax(max_norm):
    """``optax.clip_by_global_norm`` in front of adam: ``g c / ||g||``
    above the norm (the gradients' global norms are 0.9-1.2), ``g``
    below."""
    grads = grad_sequence(6, seed=3)
    conf, sch, sch_conf = CASES["adam"]
    want = jax_run("adam", conf, sch, sch_conf, grads, grad_clip=max_norm)
    got = port_run("adam", conf, sch, sch_conf, grads, grad_clip=max_norm)
    assert movement_err(want, got) <= REL
    g = [torch.as_tensor(x) for x in grads[0].values()]
    clipped = toptim.clip_by_global_norm(g, max_norm)
    norm = float(torch.sqrt(sum((c * c).sum() for c in clipped)))
    if max_norm > 1:
        assert all(torch.equal(a, b) for a, b in zip(g, clipped))
    else:
        assert norm == pytest.approx(max_norm, rel=1e-12)


def test_reduce_on_plateau_matches_optax():
    """scheduler=plateau: the plateau rule fed the training loss every
    step.  The loss falls, then stalls: with patience 2 the scale halves
    within the 12 steps, and the port's scale follows optax's."""
    grads = grad_sequence(12, seed=4)
    values = [1.0, 0.9, 0.8, 0.8, 0.8, 0.8, 0.81, 0.8, 0.8, 0.5, 0.5, 0.5]
    conf = {"lr": 1e-3}
    sch_conf = {"factor": 0.5, "patience": 2, "min_lr": 1e-5}
    want_scales = []
    want = jax_run("adam", conf, "plateau", sch_conf, grads, values=values, scales=want_scales)
    params, opt, _, needs_value = port_setup("adam", conf, "plateau", sch_conf)
    assert needs_value
    got, scales = [], []
    for g, v in zip(grads, values):
        port_step(params, opt, g, v)
        got.append({k: p.detach().numpy().copy() for k, p in params.items()})
        scales.append(float(opt.plateau.state["scale"]))
    assert scales == want_scales and min(scales) <= 0.25
    assert movement_err(want, got) <= REL
    with pytest.raises(ValueError, match="value=loss"):
        opt.step()


def test_fast_forward_matches_jax_resume():
    """A resume without an optimizer-state file: the JAX trainer sets every
    optax ``count`` to the step (``_fast_forward_opt_counts``), the port
    every group's; the next updates agree."""
    conf, sch, sch_conf = CASES["radam"]
    grads = grad_sequence(4, seed=5)
    tx, _, _ = joptim.build("radam", dict(conf), sch, dict(sch_conf))
    params = {k: jnp.asarray(v) for k, v in init_params().items()}
    state = jtrainer._fast_forward_opt_counts(tx.init(params), 9)
    want = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = {k: params[k] + upd[k] for k in params}
        want.append({k: np.asarray(v) for k, v in params.items()})
    tparams, opt, schedule, _ = port_setup("radam", conf, sch, sch_conf)
    opt.set_count(9)
    assert opt.lr() == schedule(9)
    got = []
    for g in grads:
        port_step(tparams, opt, g)
        got.append({k: p.detach().numpy().copy() for k, p in tparams.items()})
    assert movement_err(want, got) <= REL


@pytest.mark.parametrize("name", ["radam", "novograd", "plateau"])
def test_state_dict_resume_is_exact(name, tmp_path):
    """Saved after 5 steps and loaded into a fresh optimizer (through a
    file, as the trainer's ``optstate_<n>.pt``), the next 5 steps equal an
    uninterrupted run bit for bit."""
    if name == "plateau":
        conf, sch, sch_conf = {"lr": 1e-3}, "plateau", {"factor": 0.5, "patience": 1}
        opt_name = "adam"
    else:
        (conf, sch, sch_conf), opt_name = CASES[name], name
    grads = grad_sequence(10, seed=6)
    values = np.linspace(1.0, 0.9, 10)
    whole = port_run(opt_name, conf, sch, sch_conf, grads, values=values)
    params, opt, _, _ = port_setup(opt_name, conf, sch, sch_conf)
    for i in range(5):
        port_step(params, opt, grads[i], values[i] if opt.plateau else None)
    torch.save(opt.state_dict(), tmp_path / "optstate.pt")
    snapshot = {k: p.detach().clone() for k, p in params.items()}
    params2 = {k: torch.nn.Parameter(v) for k, v in snapshot.items()}
    opt2 = toptim.build(params2.values(), opt_name, dict(conf), sch, dict(sch_conf))[0]
    opt2.load_state_dict(torch.load(tmp_path / "optstate.pt", weights_only=True))
    assert opt2.count == 5
    for i in range(5, 10):
        port_step(params2, opt2, grads[i], values[i] if opt2.plateau else None)
        for k in params2:
            assert np.array_equal(params2[k].detach().numpy(), whole[i][k]), (i, k)
