"""The port serves checkpoints the JAX package trained (orbax
``step_<n>/`` directories).

The JAX package's own ``tasks/trainer.py::save_checkpoint`` writes a small
synthesizer's perturbed variables in ``tmp_path``; the port reads them
through tensorstore (``models/convert.py::load_orbax``), finds them in
either run layout and by ``BEST`` (``tasks/trainer.py::latest_checkpoint``),
and its model then synthesizes what the JAX model does, at
``tests/test_torch_dmsp_modules.py``'s bounds.  ``tools/convert_orbax.py``
writes the port's ``step_<n>.pt``, which loads strictly.  A subprocess
shows that reading imports neither jax, flax nor orbax, and that without
tensorstore the reader names the tool.  ``proc.test`` on a JAX run is
``tests/test_torch_dmsp_evaluate.py::test_proc_test_serves_a_jax_run``.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import (PHASE_FREE_BOUND, SMALL, UT_BOUND, fix_noise, flax_init,
                                     perturb, rel_err, synth_inputs)
from torch_fdtd_string_tpu.models import synthesizer as jsyn
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu_torch.models import optim as toptim
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_orbax
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.tools.convert_orbax import convert_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")
OVERRIDES = ["experiment=synth-dmsp", "model.mode_estimator=mlp"] + [
    f"model.{k}={v}" for k, v in SMALL.items()]


def jax_variables(seed):
    jm = jsyn.Synthesizer(**SMALL)
    prep = synth_inputs()
    args = [jnp.asarray(prep[k]) for k in KEYS]
    return jm, perturb(flax_init(jm, args, jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"])),
                       seed)


def save_jax(run_dir, variables, step):
    """The JAX package's checkpoint of ``variables`` at ``step``."""
    # the TrainState's constants: every collection but params
    state = SimpleNamespace(params=variables["params"],
                            constants={"constants": variables["constants"]}, opt_state=None)
    return jtrainer.save_checkpoint(run_dir, state, step, with_opt=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory: steps 3 and 12 of two sets of weights, BEST at 3."""
    run = str(tmp_path_factory.mktemp("orbax") / "jax_run")
    jm, v3 = jax_variables(3)
    _, v12 = jax_variables(12)
    save_jax(run, v3, 3)
    save_jax(run, v12, 12)
    with open(os.path.join(jtrainer._ckpt_dir(run), "BEST"), "w") as f:
        f.write("3\t0.25")
    return SimpleNamespace(dir=run, jm=jm, variables={3: v3, 12: v12})


def test_load_orbax_reads_the_saved_tree(jax_run):
    got = load_orbax(os.path.join(jtrainer._ckpt_dir(jax_run.dir), "step_12"))
    want = jax_run.variables[12]
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_serves_the_jax_model(jax_run, monkeypatch):
    """The run's BEST checkpoint in the port synthesizes the JAX model's
    outputs with the same variables, at the module tests' bounds."""
    ckpt = ttrainer.latest_checkpoint(jax_run.dir, prefer_best=True)
    assert ckpt.endswith(os.path.join("checkpoints", "step_3"))
    model = tsyn.Synthesizer(**SMALL, generator=torch.Generator().manual_seed(9))
    assert ttrainer.load_checkpoint(ckpt, model) == 3
    fix_noise(monkeypatch)
    prep = synth_inputs()
    args = [jnp.asarray(prep[k]) for k in KEYS]
    ut_j, est_j, core_j = jax_run.jm.apply(
        jax_run.variables[3], args, jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"]),
        rngs={"noise": jax.random.key(2)})
    with torch.no_grad():
        ut_t, est_t, core_t = model([torch.as_tensor(prep[k]) for k in KEYS],
                                    torch.as_tensor(prep["f_0"]), torch.as_tensor(prep["u_0"]))
    assert rel_err(ut_j, ut_t) < UT_BOUND
    for w, g in zip(est_j + core_j, est_t + core_t):
        assert rel_err(w, g) < PHASE_FREE_BOUND


def test_latest_checkpoint_finds_the_jax_layout(jax_run, tmp_path):
    """The latest step directory, the one BEST names, the flat
    ``checkpoints/`` layout; not orbax's temporary directories nor a
    ``.pt`` being written; of a ``.pt`` and a directory of one step the
    ``.pt``; a JAX run saved without its optimizer state resumes from its
    latest step with the optimizer's count fast-forwarded (its optax state
    is ``tests/test_torch_resume_jax.py``)."""
    ck = jtrainer._ckpt_dir(jax_run.dir)
    assert ttrainer.latest_checkpoint(jax_run.dir) == os.path.join(ck, "step_12")
    flat = tmp_path / "flat"
    os.makedirs(flat / "checkpoints" / "step_5")
    os.makedirs(flat / "checkpoints" / "step_9.orbax-checkpoint-tmp-17")
    (flat / "checkpoints" / "step_11.pt.tmp42").write_bytes(b"")
    assert ttrainer.latest_checkpoint(str(flat)) == str(flat / "checkpoints" / "step_5")
    (flat / "checkpoints" / "step_5.pt").write_bytes(b"")
    assert ttrainer.latest_checkpoint(str(flat)) == str(flat / "checkpoints" / "step_5.pt")
    (flat / "checkpoints" / "BEST").write_text("5\t1.0")
    assert ttrainer.latest_checkpoint(str(flat), prefer_best=True).endswith("step_5.pt")
    model, want = tsyn.Synthesizer(**SMALL), tsyn.Synthesizer(**SMALL)
    optimizer = toptim.build(model.parameters(), "radam", {"lr": 1e-3}, "noam",
                             {"warmup_steps": 1000})[0]
    assert ttrainer.restore(jax_run.dir, model, optimizer) == 12
    assert optimizer.count == 12 and not optimizer.state
    ttrainer.load_checkpoint(os.path.join(ck, "step_12"), want)
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_convert_tool_writes_strict_checkpoints(jax_run, tmp_path):
    out = str(tmp_path / "converted")
    written = convert_run(jax_run.dir, out, OVERRIDES)
    assert [os.path.basename(p) for p in written] == ["step_3.pt", "step_12.pt"]
    best = ttrainer.latest_checkpoint(out, prefer_best=True)
    assert best == written[0]
    from_pt = tsyn.Synthesizer(**SMALL)
    from_dir = tsyn.Synthesizer(**SMALL, generator=torch.Generator().manual_seed(4))
    assert ttrainer.load_checkpoint(best, from_pt) == 3
    ttrainer.load_checkpoint(os.path.join(jtrainer._ckpt_dir(jax_run.dir), "step_3"), from_dir)
    ckpt = torch.load(best, weights_only=True)
    assert sorted(ckpt) == ["constants", "params", "step"]
    for k, v in from_dir.state_dict().items():
        assert torch.equal(from_pt.state_dict()[k], v), k
    with pytest.raises(ValueError, match="shape"):
        convert_run(jax_run.dir, str(tmp_path / "wider"), OVERRIDES + ["model.n_bands=11"])
    with pytest.raises(FileNotFoundError):
        convert_run(str(tmp_path / "none"), str(tmp_path / "x"), OVERRIDES)


def test_reading_imports_no_jax(jax_run, tmp_path):
    """In a fresh process: the reader, the trainer's load and the tool
    import neither jax, flax nor orbax; with tensorstore hidden the reader
    raises an ImportError naming the tool."""
    step = os.path.join(jtrainer._ckpt_dir(jax_run.dir), "step_3")
    code = f"""
import sys
from torch_fdtd_string_tpu_torch.models import synthesizer
from torch_fdtd_string_tpu_torch.models.convert import load_orbax
from torch_fdtd_string_tpu_torch.tasks import trainer
from torch_fdtd_string_tpu_torch.tools.convert_orbax import convert_run
model = synthesizer.Synthesizer(**{SMALL!r})
assert trainer.load_checkpoint({step!r}, model) == 3
convert_run({jax_run.dir!r}, {str(tmp_path / "out")!r}, {OVERRIDES!r})
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax",
                                                      "torch_fdtd_string_tpu")]
assert not bad, bad
sys.modules["tensorstore"] = None
try:
    load_orbax({step!r})
except ImportError as err:
    assert "tools/convert_orbax.py" in str(err), err
else:
    raise AssertionError("read without tensorstore")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
