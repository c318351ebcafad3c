"""The port's data parallelism (``parallel/mesh.py``) on two CPU ranks.

Two processes on ``gloo``, spawned as ``tests/test_distributed.py`` spawns
them, run one job (:func:`job`): rank 0 joins the group from the JAX
package's ``FDTD_*`` variables and rank 1 from torchrun's; an all-reduce and
an all-gather of rank-filled rows; a generation and a training run at a
batch of 7, refused; sharded generation (``tasks/simulate.py::simulate``)
in float32 and in float64; the data-parallel train step, with ``'f0'`` in the criteria and the noise
branch on; a fused corpus through ``run.main``, then ``trainer.train`` on
it, resumed.  While the ranks run, a third process makes the one-rank
corpus and training run, and this process the other references: the
port's one-rank generation and step, the JAX package's 8-device virtual
mesh run and mesh train step.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu_torch.ops import fdm as tfdm
from torch_fdtd_string_tpu_torch.parallel import mesh
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim

# The ranks import this module for port_step; the JAX package is imported
# in the functions of this process alone, so that a rank imports no JAX.

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000
# the string draws of tests/test_parallel.py::test_production_simulate_uses_mesh_and_matches_single
SIM = dict(
    string_kwargs=dict(
        f0_min=150.0, f0_max=290.0, f0_mod_max=0.0, f0_diff_max=0.0,
        kappa_min=0.02, kappa_max=0.02, alpha_min=1.0, alpha_max=3.0,
        p_a_min=0.005, p_a_max=0.01, p_x_min=0.3, p_x_max=0.5,
    ),
    precision="single", collect_state=False,
)
GEN_B, GEN_LENGTH = 8, 0.05  # that test's batch and length
# the sharded port's output against the JAX 8-device mesh run, relative to
# the output's scale.  That test holds the JAX mesh to one JAX device at
# 1e-4; the port and the JAX package drift apart by float32 rounding
# compounded over the run's 2,400 steps (2.3e-3 of scale at one rank or
# two, read on the CPU), so the bound is set above that reading
SIM_JAX = 5e-3
# a float64 batch of 5 ms (240 steps): the engine's coupling sweeps exit
# batch-wide at 100 eps (2.2e-14) of a string's scale, so a rank's half
# batch may sweep fewer times than the whole; read 1.5e-14 of scale on the
# CPU, one rank against two
GEN_LENGTH64, SIM64 = 0.005, 1e-12
# the widths of tests/test_parallel.py::test_dmsp_gradients_identical_under_dp
MODEL = dict(n_modes=6, n_bands=9, hidden_dim=16, embed_dim=8, block_size=256)
STEP_B, STEP_NT, STEP_NX = 8, 1024, 32
CRITERIA = ["l1", "modeamps", "f0"]
# the float64 step on two ranks against one, relative to each tensor's
# scale: the two differ in the summation order of the batch means
STEP64 = 1e-10
# the float32 step against the JAX mesh step: test_parallel.py's bounds
RTOL32, ATOL32 = 1e-5, 2e-6
# trainer.train: the float32 parameters after two steps on two ranks
# against one, relative to each tensor's scale
TRAIN32 = 1e-5
# a fused corpus of six plucked strings of 25 ms, four kept pickup columns
# each (tests/test_torch_dmsp_train.py's): 4 train strings (16 items, 2
# steps of 8 per epoch), 1 valid, 1 test
CORPUS = ["experiment=nsynth-like", "task.num_samples=6", "task.batch_size=6",
          "task.length=0.025", "task.chunk_length=0.025", "task.save_x_stride=16",
          "task.process_Nx=64", "task.save=false", "task.save_output_wav=false",
          "proc.cpu=true"]
SMALL = dict(n_modes=8, n_bands=9, hidden_dim=16, embed_dim=8, block_size=64)
TRAIN = ["experiment=synth-dmsp", "proc.train=true", "proc.test=true", "task.plot=false",
         "task.batch_size=8", "task.valid_batch_size=8", "task.test_batch_size=8",
         "proc.cpu=true"] + [f"model.{k}={v}" for k, v in SMALL.items()]

WORKER = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, os.environ["FDTD_ROOT"])
    sys.path.insert(0, os.path.join(os.environ["FDTD_ROOT"], "tests"))
    import numpy as np
    import torch
    from torch_fdtd_string_tpu_torch import run
    from torch_fdtd_string_tpu_torch.parallel import mesh
    from torch_fdtd_string_tpu_torch.tasks import simulate, trainer

    spec = json.loads(sys.argv[1])
    out = spec["out"]
    r = int(os.environ.get("FDTD_PROC_ID", os.environ.get("RANK", "0")))

    def save(name, **arrays):
        np.savez(os.path.join(out, f"{name}-rank{r}.npz"), **arrays)

    assert mesh.init_distributed(cpu=True)
    assert (mesh.rank(), mesh.world_size()) == (r, 2), (mesh.rank(), mesh.world_size())

    # the group: rows filled with (rank + 1), as the JAX test
    rows = torch.full((3, 4), float(r + 1))
    save("group", total=mesh.all_reduce(rows.sum().reshape(1)).numpy(),
         gathered=mesh.all_gather_rows(rows).numpy(), backend=torch.distributed.get_backend())

    # a batch of 7 refused before a string is simulated or a step taken
    refused, calls = {}, []
    process, make_step = simulate.process, trainer.S.make_train_step
    simulate.process = lambda *a, **k: calls.append("process")
    trainer.S.make_train_step = lambda *a, **k: calls.append("train_step")
    for what, argv in spec["refusals"].items():
        try:
            run.main(argv)
            refused[what] = None
        except ValueError as err:
            refused[what] = str(err)
    simulate.process, trainer.S.make_train_step = process, make_step
    with open(os.path.join(out, f"refused-rank{r}.json"), "w") as f:
        json.dump(dict(refused, calls=calls), f)

    # sharded generation, in single and in double precision
    rows = mesh.shard_rows(spec["B"])
    for name, length, precision in (("simulate", spec["length"], "single"),
                                    ("simulate64", spec["length64"], "double")):
        res, (string, *_), _, _ = simulate.simulate(
            "pluck", 48000, simulate.fdm.get_theta(0.02, 150.0, 48000), length, spec["B"],
            150.0, 1.0, 1.0, cpu=True, rng=np.random.default_rng(5), rows=rows,
            **dict(spec["kw"], precision=precision))
        save(name, uout=res[0], f0=string.f0, lo=rows.start, hi=rows.stop)

    # the data-parallel train step
    from test_torch_parallel import port_step

    for name, dtype, sharded_f0, fixed_noise in spec["steps"]:
        loss, params = port_step(spec["inputs"], dtype, sharded_f0, fixed_noise, shard=True)
        if r == 0:
            save(name, loss=loss, **params)

    # a corpus, then two training runs on it; who writes what
    run.main(spec["corpus"])
    if r == 0:
        from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits
        make_splits(spec["prep"], valid_n=1, test_n=1)
    mesh.barrier()
    writes = []
    for name in ("save_checkpoint", "_log"):
        fn = getattr(trainer, name)
        setattr(trainer, name, lambda *a, _fn=fn, _n=name, **k: (writes.append(_n),
                                                                 _fn(*a, **k))[1])
    for argv in spec["train"]:
        run.main(argv)
    with open(os.path.join(out, f"train-rank{r}.json"), "w") as f:
        json.dump(writes, f)
    mesh.destroy()
    print("RANK_OK", r)
''')

# the one-rank reference of the corpus and the training run, a process of
# its own beside the ranks
ONE_RANK = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, os.environ["FDTD_ROOT"])
    from torch_fdtd_string_tpu_torch import run
    from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits

    spec = json.loads(sys.argv[1])
    run.main(spec["corpus"])
    print("SPLITS", json.dumps(make_splits(spec["prep"], valid_n=1, test_n=1)))
    run.main(spec["train"])
    print("RANK_OK one")
''')


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(tmp, spec, one_rank):
    """Start the worker on two gloo ranks (rank 0 joining from ``FDTD_*``,
    rank 1 from torchrun's variables) and the one-rank process with
    ``one_rank``.  Returns a ``wait()`` that fails the test unless all
    three end well within ``timeout``, and stops them; it returns the
    one-rank process's output."""
    port = _free_port()
    jobs = []
    for name, code, arg, extra in (
            ("0", WORKER, spec, dict(FDTD_COORD=f"127.0.0.1:{port}", FDTD_NPROCS="2",
                                     FDTD_PROC_ID="0")),
            ("1", WORKER, spec, dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1")),
            ("one", ONE_RANK, one_rank, {})):
        script = tmp / f"worker-{name}.py"
        script.write_text(code)
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        for key in ("FDTD_COORD", "FDTD_NPROCS", "FDTD_PROC_ID", "RANK", "WORLD_SIZE",
                    "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        env.update(FDTD_ROOT=ROOT, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", **extra)
        log = open(tmp / f"rank-{name}.log", "w")
        jobs.append((name, log, subprocess.Popen(
            [sys.executable, str(script), json.dumps(arg)], env=env, cwd=str(tmp),
            stdout=log, stderr=subprocess.STDOUT, text=True)))

    def wait(timeout=300):
        try:
            for _, _, p in jobs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pytest.fail("a rank timed out")
        finally:
            for _, log, p in jobs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        texts = {}
        for name, _, p in jobs:
            texts[name] = (tmp / f"rank-{name}.log").read_text()
            assert p.returncode == 0 and f"RANK_OK {name}" in texts[name], \
                f"rank {name}:\n{texts[name][-6000:]}"
        return texts["one"]

    return wait


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def fixed_uniform(shape):
    """The noise draw of tests/test_torch_dmsp_modules.py's equality tests."""
    return np.random.default_rng(123).random(tuple(shape)).astype(np.float32)


def step_inputs(path):
    """The JAX DP test's batch (test_parallel.py:54-70), with a pitch
    track that varies over the batch, so that one shard's f0 statistics
    differ from the whole batch's, and flax variables moved off their
    init; saved for the ranks.  Returns the path."""
    import jax
    import jax.numpy as jnp

    from test_torch_dmsp_modules import perturb
    from torch_fdtd_string_tpu.models.synthesizer import Synthesizer

    B, Nt, Nx, block = STEP_B, STEP_NT, STEP_NX, MODEL["block_size"]
    n_frames = Nt // block + 1
    rng = np.random.default_rng(0)
    prep = {
        "xg": rng.random((B, 1)).astype(np.float32),
        "tg": np.tile(np.arange(Nt, dtype=np.float32) / 48000.0, (B, 1)),
        "ka": np.full((B, 1), 0.02, np.float32),
        "al": np.full((B, 1), 2.0, np.float32),
        "t60": np.tile(np.array([[[1000.0, 20.0], [100.0, 18.0]]], np.float32), (B, 1, 1)),
        "f_k": (0.02 + 0.001 * rng.random((B, 1, 6))).astype(np.float32),
        "c_k": (0.01 * rng.random((B, 1, 6))).astype(np.float32),
        "f_0": np.full((B, n_frames), 220.0, np.float32),
        "u_0": (0.01 * rng.random((B, 1, Nx))).astype(np.float32),
        "gt": (rng.normal(size=(B, Nt)) * 0.1).astype(np.float32),
        "gt_f0": (0.028 + 0.004 * rng.random((B, n_frames))
                  + 0.002 * np.arange(B)[:, None]).astype(np.float32),
    }
    model = Synthesizer(**MODEL)
    keys = ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")
    variables = model.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                           [jnp.asarray(prep[k]) for k in keys], jnp.asarray(prep["f_0"]),
                           jnp.asarray(prep["u_0"]))
    np.savez(path, **prep)
    with open(f"{path}.vars.pkl", "wb") as f:
        pickle.dump(perturb(variables, 3), f)
    return str(path)


def port_step(inputs, dtype, sharded_f0, fixed_noise, shard):
    """One sgd(1e-2) train step of the port's synthesizer carrying the
    saved flax variables, in ``dtype``, on this rank's rows of the saved
    batch (all of it without ``shard``), the noise from a seeded
    generator or fixed; returns the global loss and the parameters after
    the step, numpy float64."""
    from torch_fdtd_string_tpu_torch.models import optim as toptim
    from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
    from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables
    from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    dt = getattr(torch, dtype)
    with open(f"{inputs}.vars.pkl", "rb") as f:
        variables = pickle.load(f)
    model = load_jax_variables(tsyn.Synthesizer(**MODEL), variables).to(dt)
    mesh.replicate(model)
    with np.load(inputs) as z:
        prep = {k: torch.as_tensor(z[k]).to(dt) for k in z.files}
    B = prep["gt"].shape[0]
    rows = (mesh.shard_rows(B), B) if shard else None
    if shard:
        prep = mesh.shard_batch(prep, B)
    opt, _, _ = toptim.build(model.parameters(), "sgd", {"lr": 1e-2, "momentum": None},
                             None, {})
    step = S.make_train_step(model, opt, build_loss_registry(SR, STEP_NT, sharded=sharded_f0),
                             CRITERIA, True, shard=rows)
    state = S.TrainState(model, opt, 0, torch.Generator().manual_seed(11))
    uniform = tsyn.uniform
    if fixed_noise:
        tsyn.uniform = lambda shape, generator, device, d: torch.as_tensor(
            fixed_uniform(shape), device=device).to(d)
    try:
        _, losses = step(state, prep)
    finally:
        tsyn.uniform = uniform
    return (float(losses["loss"]),
            {k: p.detach().double().numpy() for k, p in model.named_parameters()})


def jax_simulate():
    """The JAX package's run of the mesh test's draws on its 8-device
    virtual mesh."""
    import jax

    from torch_fdtd_string_tpu.ops import fdm as jfdm
    from torch_fdtd_string_tpu.tasks import simulate as jsim

    assert len(jax.devices()) >= 8
    res, _, _ = jsim.simulate("pluck", SR, jfdm.get_theta(0.02, 150.0, SR), GEN_LENGTH, GEN_B,
                              150.0, 1.0, 1.0, cpu=True, rng=np.random.default_rng(5), **SIM)
    return np.asarray(res[0])


def jax_mesh_step(inputs):
    """The JAX package's sgd(1e-2) train step of the saved variables on its
    8-device mesh, the noise fixed: ``(loss, params under the port's
    names)``."""
    import jax
    import jax.numpy as jnp
    import optax

    from torch_fdtd_string_tpu.models.losses import build_loss_registry
    from torch_fdtd_string_tpu.models.synthesizer import Synthesizer
    from torch_fdtd_string_tpu.parallel.mesh import make_mesh, shard_batch
    from torch_fdtd_string_tpu.tasks import synthesize as JS
    from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
    from torch_fdtd_string_tpu_torch.models.convert import state_dict_from_jax

    with open(f"{inputs}.vars.pkl", "rb") as f:
        variables = pickle.load(f)
    tx = optax.sgd(1e-2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JS.TrainState(params, {"constants": variables["constants"]}, tx.init(params), 0,
                          jax.random.key(2))
    step_fn = JS.make_train_step(Synthesizer(**MODEL), tx, build_loss_registry(SR, STEP_NT),
                                 CRITERIA, True)
    with np.load(inputs) as z:
        prep = {k: jnp.asarray(z[k]) for k in z.files}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, dtype=None, **kw: jnp.asarray(fixed_uniform(shape)))
        state, losses = step_fn(state, shard_batch(prep, make_mesh(8)))
    sd = state_dict_from_jax(tsyn.Synthesizer(**MODEL),
                             {"params": jax.tree.map(np.asarray, state.params),
                              "constants": variables["constants"]})
    return float(np.asarray(losses["loss"])), {k: np.asarray(v, np.float64)
                                                for k, v in sd.items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-rank job and the one-rank process, and this process's
    references, made while they run."""
    tmp = tmp_path_factory.mktemp("parallel")
    root = str(tmp)
    out = tmp / "out"
    out.mkdir()
    inputs = step_inputs(tmp / "step.npz")
    at = lambda name: [f"task.root_dir={root}", f"task.save_name={name}"]
    data = lambda name: [f"task.load_dir={root}", f"task.load_name={name}"]
    odd = [f"task.root_dir={root}", "proc.cpu=true", "task.randomize_name=false",
           "task.batch_size=7"]
    wait = start(tmp, dict(
        out=str(out), B=GEN_B, length=GEN_LENGTH, length64=GEN_LENGTH64, kw=SIM,
        inputs=inputs,
        refusals={
            "simulate": ["experiment=nsynth-like", "task.num_samples=7", "task.length=0.01",
                         "task.save_name=odd"] + odd,
            "train": ["experiment=synth-dmsp", "proc.train=true", "task.plot=false",
                      f"task.load_dir={root}", "task.load_name=none",
                      "task.save_name=odd-train"] + odd,
        },
        steps=[("f64", "float64", True, False), ("f64_local", "float64", False, False),
               ("f32", "float32", True, True)],
        corpus=CORPUS + at("corpus-two"), prep=os.path.join(root, "corpus-two-prep"),
        train=[TRAIN + at("train-two") + data("corpus-two-prep") + ["task.total_epoch=1"],
               TRAIN + at("train-two") + data("corpus-two-prep") + [
                   "task.total_epoch=2", "task.resume=true"]],
    ), dict(corpus=CORPUS + at("corpus-one"), prep=os.path.join(root, "corpus-one-prep"),
            train=TRAIN + at("train-one") + data("corpus-one-prep") + ["task.total_epoch=1"]))
    ref = {}
    ref["simulate"] = tsim.simulate(
        "pluck", SR, tfdm.get_theta(0.02, 150.0, SR), GEN_LENGTH, GEN_B, 150.0, 1.0, 1.0,
        cpu=True, rng=np.random.default_rng(5), **SIM)
    ref["simulate64"] = tsim.simulate(
        "pluck", SR, tfdm.get_theta(0.02, 150.0, SR), GEN_LENGTH64, GEN_B, 150.0, 1.0, 1.0,
        cpu=True, rng=np.random.default_rng(5), **dict(SIM, precision="double"))
    ref["jax_mesh"] = jax_simulate()
    ref["f64"] = port_step(inputs, "float64", False, False, shard=False)
    ref["jax_step"] = jax_mesh_step(inputs)
    one = wait()
    assert 'SPLITS {"train": 4, "valid": 1, "test": 1}' in one
    return dict(root=root, out=str(out), ref=ref)


def load(job, name, r=0):
    return np.load(os.path.join(job["out"], f"{name}-rank{r}.npz"))


# ---- (a) the group, from either set of variables -------------------------------

def test_group_from_fdtd_and_torchrun_variables(job):
    for r in range(2):
        res = load(job, "group", r)
        assert str(res["backend"]) == "gloo"
        assert float(res["total"][0]) == (1.0 + 2.0) * 3 * 4
        np.testing.assert_array_equal(res["gathered"], np.repeat([[1.0], [2.0]], 3, 0)
                                      * np.ones((1, 4)))


def test_one_process_starts_no_group(monkeypatch):
    for key in ("FDTD_COORD", "FDTD_NPROCS", "FDTD_PROC_ID", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.init_distributed(cpu=True) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed(cpu=True) is False
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world_size()) == (0, 1)
    assert mesh.local_device(cpu=True) == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no coordinator"):
        mesh.init_distributed(cpu=True)
    # the arguments, as the JAX package's init_distributed takes them,
    # before the variables
    assert mesh.init_distributed(num_processes=1, cpu=True) is False
    with pytest.raises(ValueError, match="process id 5 outside 2 processes"):
        mesh.init_distributed("127.0.0.1:1", 2, 5, cpu=True)
    assert not torch.distributed.is_initialized()


# ---- (b) rows, without processes ----------------------------------------------------

def test_shard_rows_and_batch():
    assert [mesh.shard_rows(8, r, 2) for r in range(2)] == [slice(0, 4), slice(4, 8)]
    assert [mesh.shard_rows(12, r, 4) for r in range(4)] == [
        slice(3 * r, 3 * r + 3) for r in range(4)]
    assert mesh.shard_rows(5) == slice(0, 5)  # one process holds every row
    tree = {"a": np.arange(16).reshape(8, 2), "b": [torch.arange(8), np.zeros((3, 8))],
            "c": 7, "d": torch.zeros(())}
    parts = [mesh.shard_batch(tree, 8, r, 2) for r in range(2)]
    np.testing.assert_array_equal(parts[1]["a"], np.arange(8, 16).reshape(4, 2))
    assert parts[0]["b"][0].tolist() == [0, 1, 2, 3]
    assert parts[1]["b"][1].shape == (3, 8)  # leading dimension is not the batch's
    assert parts[0]["c"] == 7 and parts[0]["d"].shape == ()
    np.testing.assert_array_equal(np.concatenate([p["a"] for p in parts]), tree["a"])


# ---- (c) sharded generation ----------------------------------------------------------------

def test_sharded_generation_matches_one_rank_and_jax_mesh(job):
    parts = [load(job, "simulate", r) for r in range(2)]
    assert [(int(p["lo"]), int(p["hi"])) for p in parts] == [(0, 4), (4, 8)]
    uout = np.concatenate([p["uout"] for p in parts])
    res, (string, *_), _, _ = job["ref"]["simulate"]
    single = res[0]
    # each rank drew the whole batch and kept its rows
    np.testing.assert_array_equal(np.concatenate([p["f0"] for p in parts]), string.f0)
    # each string at its whole-batch width group: bit for bit
    np.testing.assert_array_equal(uout, single)
    assert np.isfinite(uout).all() and np.abs(uout).max() > 0
    # and the JAX package's mesh run within SIM_JAX of its scale
    jax_mesh = job["ref"]["jax_mesh"]
    assert rel(jax_mesh, uout) <= SIM_JAX, rel(jax_mesh, uout)


def test_sharded_float64_generation_within_sweep_tolerance(job):
    """A float64 batch (the f64 engine) on two ranks against one."""
    parts = [load(job, "simulate64", r) for r in range(2)]
    uout = np.concatenate([p["uout"] for p in parts])
    res, (string, *_), _, _ = job["ref"]["simulate64"]
    np.testing.assert_array_equal(np.concatenate([p["f0"] for p in parts]), string.f0)
    assert uout.dtype == np.float64 and uout.shape == res[0].shape
    assert np.isfinite(uout).all() and np.abs(uout).max() > 0
    assert rel(res[0], uout) <= SIM64, rel(res[0], uout)


def test_sharded_corpus_equals_one_rank_corpus(job):
    """``run.main`` of a fused corpus on two ranks writes the one-rank
    run's items, under the same names, bit for bit; rank 0 alone writes
    the provenance line."""
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    one, two = (os.path.join(job["root"], f"corpus-{n}-prep") for n in ("one", "two"))
    n_items = 0
    for split in ("train", "valid", "test"):
        items = sorted(os.listdir(os.path.join(one, split)))
        assert items == sorted(os.listdir(os.path.join(two, split)))
        for item in items:
            a, b = os.path.join(one, split, item), os.path.join(two, split, item)
            assert sorted(os.listdir(a)) == sorted(os.listdir(b))
            za, zb = np.load(os.path.join(a, "parameters.npz")), np.load(
                os.path.join(b, "parameters.npz"))
            assert za.files == zb.files
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key], err_msg=f"{item} {key}")
            for name in os.listdir(a):
                if name.endswith(".wav"):
                    np.testing.assert_array_equal(wavio.read(os.path.join(a, name))[0],
                                                  wavio.read(os.path.join(b, name))[0])
            n_items += 1
    assert n_items == 6
    with open(os.path.join(two, "_gen_meta.jsonl")) as f:
        assert len(f.readlines()) == 1


# ---- (d) the data-parallel train step ----------------------------------------------------------

def step_result(job, name):
    z = dict(load(job, name))
    return float(z.pop("loss")), z


def test_train_step_float64_matches_one_rank(job):
    loss1, params1 = job["ref"]["f64"]
    loss2, params2 = step_result(job, "f64")
    assert abs(loss2 - loss1) <= STEP64 * abs(loss1), (loss1, loss2)
    for k, p in params1.items():
        assert rel(p, params2[k]) < STEP64, (k, rel(p, params2[k]))
    # what the global f0 statistics are for: per-shard ones train on
    # another loss, far outside the bound
    loss3, params3 = step_result(job, "f64_local")
    assert abs(loss3 - loss1) > 1e3 * STEP64 * abs(loss1), (loss1, loss3)
    assert max(rel(p, params3[k]) for k, p in params1.items()) > 1e3 * STEP64


def test_train_step_float32_matches_jax_mesh(job):
    loss_j, params_j = job["ref"]["jax_step"]
    loss2, params2 = step_result(job, "f32")
    np.testing.assert_allclose(loss2, loss_j, rtol=RTOL32)
    assert set(params2) <= set(params_j)  # the state dict adds the constants
    for k, p in params2.items():
        np.testing.assert_allclose(p, params_j[k], atol=ATOL32, err_msg=k)


# ---- (e) trainer.train on two ranks, resumed ----------------------------------------------

def test_trainer_on_two_ranks_matches_one_and_resumes(job):
    from torch_fdtd_string_tpu_torch.tasks import trainer

    root = job["root"]
    writes = []
    for r in range(2):
        with open(os.path.join(job["out"], f"train-rank{r}.json")) as f:
            writes.append(json.load(f))
    assert writes[1] == [] and "save_checkpoint" in writes[0] and "_log" in writes[0]
    ck = lambda name, step: torch.load(
        os.path.join(trainer._ckpt_dir(os.path.join(root, name)), f"step_{step}.pt"),
        weights_only=True)
    one, two = ck("train-one", 2), ck("train-two", 2)
    assert two["step"] == one["step"] == 2
    for k, p in one["params"].items():
        assert rel(p.numpy(), two["params"][k].numpy()) < TRAIN32, k
    resumed = ck("train-two", 4)
    assert resumed["step"] == 4
    assert any(not torch.equal(resumed["params"][k], v) for k, v in two["params"].items())
    with open(os.path.join(root, "train-two", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["split"] == "valid"] == [2, 4]
    # each run: the test split each validation epoch, then proc.test's metrics
    assert [r.get("step") for r in recs if r["split"] == "test"] == [2, None, 4, None]
    with open(os.path.join(trainer._ckpt_dir(os.path.join(root, "train-two")), "BEST")) as f:
        assert f.read().split()[0] in ("2", "4")
    assert sorted(os.listdir(os.path.join(root, "train-two", "score"))) == [
        "modals.txt", "output.txt"]


# ---- (f) a batch that does not divide is refused before any work -------------------------

def test_indivisible_batch_refused(job):
    for r in range(2):
        with open(os.path.join(job["out"], f"refused-rank{r}.json")) as f:
            refused = json.load(f)
        for what in ("simulate", "train"):
            msg = refused[what]
            assert msg and "batch_size 7" in msg and "world size 2" in msg, (what, msg)
        assert refused["calls"] == []
