"""DMSP training in the port against the JAX package's.

``proc.train`` end to end through ``run.main`` on a corpus the port
generates, against JAX ``trainer.train`` from the same initial weights;
the resume, the checkpoints with optimizer state, ``BEST``, the device
cache and the streaming path, the eval sweep's out-of-memory backoff, the
figures, the code snapshot.  float32 on both sides (the JAX package with
x64 on, tests/conftest.py).  The train step itself is
``tests/test_torch_dmsp_train_step.py``.
"""

import glob
import json
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import SMALL, fix_noise
from torch_fdtd_string_tpu.data import dataset as jdata
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.core import analytic as tanalytic
from torch_fdtd_string_tpu_torch.data import dataset as tdata
from torch_fdtd_string_tpu_torch.models import optim as toptim
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables
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
    task.plot=true on a host without matplotlib it raises an ImportError
    naming task.plot=false; with task.ckpt_dir it refuses to score another
    run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = [o for o in TRAIN if o != "proc.cpu=true"] + [f"task.load_dir={corpus}",
                                                         f"task.root_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        trun.main(over + ["task.save_name=nocard"])
    with monkeypatch.context() as m, pytest.raises(ImportError, match="task.plot=false"):
        m.setitem(sys.modules, "matplotlib", None)
        trun.main(over + ["task.save_name=plot", "task.plot=true", "proc.cpu=true"])
    with pytest.raises(ValueError, match="ckpt_dir"):
        trun.main(over + ["task.save_name=ck", "proc.cpu=true", "task.total_epoch=0",
                          f"task.ckpt_dir={tmp_path}"])


def test_training_and_scoring_draw_as_jax(corpus, tmp_path, monkeypatch):
    """``proc.train proc.test task.plot=true``: the first validation
    batch's panels (``plots/valid_<step>/``) and the first test batch's
    spectrograms, under the names the JAX package's callbacks give arrays
    of the same shapes; with ``task.plot_test_video=true`` every test
    batch's state summary, the string's columns its spatial axis (the
    drawing itself: ``tests/test_torch_plot.py``)."""
    from torch_fdtd_string_tpu.tasks import callbacks as jcallbacks
    from torch_fdtd_string_tpu.utils import plot as jplot

    over = [o for o in TRAIN if o != "task.plot=false"] + [
        "task.plot=true", f"task.load_dir={corpus}", f"task.root_dir={tmp_path}",
        "task.save_name=run"]
    run = trun.main(over)
    got = sorted(os.path.relpath(p, run) for p in glob.glob(f"{run}/**/*", recursive=True)
                 if os.path.isfile(p) and os.path.relpath(p, run).startswith(("plots", "test_")))
    jdir = str(tmp_path / "jax")
    waves = {k: np.full((4, 2400), 1e-3) for k in ("preds", "target")}
    jcallbacks.plot_results(jdir, "valid", waves, SR, step=2)
    jplot.rainbowgram(f"{jdir}/test_pred_spec.pdf", waves["preds"][0], SR)
    jplot.rainbowgram(f"{jdir}/test_target_spec.pdf", waves["target"][0], SR)
    jplot.est_tar_specs(f"{jdir}/test_specs", waves["preds"], waves["target"], waves["preds"],
                        SR)
    assert got == sorted(os.path.relpath(p, jdir) for p in glob.glob(f"{jdir}/**/*",
                                                                     recursive=True)
                         if os.path.isfile(p))

    # the checkpoints alone, without the run's code snapshot (which would
    # score with its own copy of the trainer)
    shutil.copytree(os.path.join(run, "string"), tmp_path / "ck" / "string")
    calls = []
    monkeypatch.setattr(ttrainer, "plot_state_video",
                        lambda d, est, ana, tar, sr, name: calls.append(
                            (os.path.basename(d), est.shape, ana.shape, tar.shape, name)))
    trun.main([o for o in over if not o.startswith(("proc.train", "task.plot=",
                                                     "task.save_name"))]
              + ["proc.train=false", "task.plot_test_video=true",
                 f"task.ckpt_dir={tmp_path / 'ck'}", "task.save_name=video"])
    assert calls == [("state", (2400, 4), (2400, 4), (2400, 4), "0-0")]


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
