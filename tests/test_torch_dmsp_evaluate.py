"""``proc.test`` end to end against the JAX package's ``trainer.evaluate``.

The port generates a tiny fused nsynth-like corpus on the CPU
(``proc.cpu=true``), its ``tools/make_splits`` splits it, and both packages
score the test split with the same weights: the JAX package from an orbax
checkpoint this test writes, the port (through ``run.main``) from the
checkpoint of the weights ``models/convert.py`` carries across.  The noise
draw is fixed on both sides to one seeded array.  Also: the dataset, the
loader, the splits, the checkpoints and the refusals.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import SMALL, fix_noise, flax_init, perturb, synth_inputs
from torch_fdtd_string_tpu.data import dataset as jdata
from torch_fdtd_string_tpu.tasks import synthesize as jsynth
from torch_fdtd_string_tpu.tasks import trainer as jtrainer
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.data import dataset as tdata
from torch_fdtd_string_tpu_torch.models import synthesizer as tsyn
from torch_fdtd_string_tpu_torch.models.convert import load_jax_variables, state_dict_from_jax
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")
# four plucked strings of 50 ms, four kept pickup columns each, with the
# modal baseline (ua-*.wav)
CORPUS = ["experiment=nsynth-like", "task.num_samples=4", "task.batch_size=4",
          "task.length=0.05", "task.chunk_length=0.05", "task.save_x_stride=16",
          "task.process_Nx=64", "task.save=false", "task.save_output_wav=false",
          "proc.cpu=true"]
NAME = "corpus-prep"
# one test batch of 8 and a partial batch of 4 (3 test strings x 4 columns)
TEST = ["experiment=synth-dmsp", "proc.train=false", "proc.test=true", "task.plot=false",
        f"task.load_name={NAME}", "task.test_batch_size=8", "proc.cpu=true"] + [
        f"model.{k}={v}" for k, v in SMALL.items() if k != "block_size"] + [
        f"model.block_size={SMALL['block_size']}"]
# output.txt (the model's scores) against the JAX package's, per column,
# largest difference measured over both estimators: si_sdr 6.7e-4 dB (of
# -55 dB: untrained weights), sdr 1.8e-5 dB, logmag 5.7e-4 (of 37),
# f0_error 5.5e-4 Hz (of 1036): the f32 waveform's phase sum over 2400
# samples and the conditioning's f32 sines (test_torch_dmsp_modules.py);
# the parameter columns are equal.  Bounds 10-15x
OUTPUT_BOUNDS = {"x_grid": 0.0, "kappa": 0.0, "alpha": 0.0, "p_a": 0.0, "p_x": 0.0,
                 "si_sdr": 1e-2, "sdr": 2.5e-4, "logmag": 8e-3, "f0_error": 6e-3}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's fused corpus, split by the port's make_splits: 3 test
    strings, 1 valid.  Returns the load_dir."""
    root = tmp_path_factory.mktemp("dmsp_corpus")
    tsim.run(tcompose(trun.CONFIG_DIR, CORPUS), str(root / "corpus"), "pluck", 1)
    counts = make_splits(str(root / NAME), valid_n=1, test_n=3)
    assert counts == {"train": 0, "valid": 1, "test": 3}
    return str(root)


def _table(path):
    with open(path) as f:
        lines = f.read().strip().split("\n")
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:]]
    return header, [r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows])


def _variables(estimator, seed=1):
    """Perturbed flax variables of the small synth-dmsp model."""
    jargs = jcompose(JAX_CONFIG_DIR, TEST + [f"model.mode_estimator={estimator}"])
    jm = jsynth.build_model(jargs)
    prep = synth_inputs(B=2, Nt=2400, n_modes=SMALL["n_modes"], block=SMALL["block_size"])
    args = [jnp.asarray(prep[k]) for k in ("xg", "tg", "ka", "al", "t60", "f_k", "c_k")]
    return perturb(flax_init(jm, args, jnp.asarray(prep["f_0"]), jnp.asarray(prep["u_0"])),
                   seed)


@pytest.mark.parametrize("estimator", ["mlp", "physics"])
def test_proc_test_matches_jax_evaluate(corpus, tmp_path, monkeypatch, estimator):
    fix_noise(monkeypatch)
    over = TEST + [f"task.load_dir={corpus}", f"model.mode_estimator={estimator}"]
    variables = _variables(estimator)

    jax_run = str(tmp_path / "jax")
    jargs = jcompose(JAX_CONFIG_DIR, over)
    jargs.task.ckpt_dir = jax_run
    # the JAX TrainState's constants are every collection but params
    jtrainer.save_checkpoint(jax_run, jsynth.TrainState(
        variables["params"], {"constants": variables["constants"]}, None, 0, None), 0,
        with_opt=False)
    jtrainer.evaluate(jargs, jax_run)

    targs = tcompose(trun.CONFIG_DIR, over)
    model = load_jax_variables(tsynth.build_model(targs), variables)
    port_run = str(tmp_path / "port")
    ttrainer.save_checkpoint(port_run, model, 0)
    assert trun.main(over + [f"task.root_dir={tmp_path}", "task.save_name=port",
                             "task.save_results=true"]) == port_run
    # task.save_results: every test item's synthesized wave, named by its id
    waves = sorted(os.listdir(os.path.join(port_run, "eval", NAME, "wave")))
    assert waves == sorted([f"0-0-{i}.wav" for i in range(8)] + [f"0-1-{i}.wav" for i in range(4)])

    # no partial table left, the same ids in the same order, the header
    assert not glob.glob(os.path.join(port_run, "score", "*partial*"))
    for name in ("modals", "output"):
        jh, jids, jrows = _table(os.path.join(jax_run, "score", f"{name}.txt"))
        th, tids, trows = _table(os.path.join(port_run, "score", f"{name}.txt"))
        assert th == jh == ["id"] + ttrainer.HEADER
        assert tids == jids == [f"0-0-{i}" for i in range(8)] + [f"0-1-{i}" for i in range(4)] + [
            "# mean"]
        assert np.isfinite(trows).all()
        if name == "modals":  # the baseline does not depend on the model
            np.testing.assert_allclose(trows, jrows, rtol=0, atol=1e-6)
            modal_rows = trows
        else:
            for c, col in enumerate(ttrainer.HEADER):
                err = np.abs(trows[:, c] - jrows[:, c]).max()
                assert err <= OUTPUT_BOUNDS[col], (col, err)
    # the modal baseline is a real one (save_modal), not zeros: on every
    # sounding item (x_grid > 0; the fixed end is silent in target and
    # baseline alike) it scores above 0 dB si_sdr, where a silent estimate
    # scores ~-80 dB, with a non-zero logmag
    col = {c: ttrainer.HEADER.index(c) for c in ("x_grid", "si_sdr", "logmag")}
    sounding = modal_rows[:-1][modal_rows[:-1, col["x_grid"]] > 0]
    assert len(sounding) == 9
    assert (sounding[:, col["si_sdr"]] > 0).all() and (sounding[:, col["logmag"]] > 0).all()
    recs = [json.loads(line) for line in open(os.path.join(port_run, "metrics.jsonl"))]
    jrecs = [json.loads(line) for line in open(os.path.join(jax_run, "metrics.jsonl"))]
    assert sorted(recs[-1]) == sorted(jrecs[-1]) == ["split", "test/modeamps",
                                                     "test/modefreq", "test/sisdr"]
    # the physics estimator meets the dataset's mode tables to float32
    # rounding (modeamps ~1e-10), hence the absolute floor
    for key in ("test/modeamps", "test/modefreq"):
        assert recs[-1][key] == pytest.approx(jrecs[-1][key], rel=1e-4, abs=1e-8)
    assert recs[-1]["test/sisdr"] == pytest.approx(jrecs[-1]["test/sisdr"], abs=1e-2)


def test_proc_test_serves_a_jax_run(corpus, tmp_path, monkeypatch):
    """``proc.test task.ckpt_dir=<a JAX run>``: the port scores the run the
    JAX package's ``save_checkpoint`` wrote (orbax ``step_<n>/``; its
    ``codes/`` snapshot is the JAX package's, which the port never runs),
    by its BEST step, equal to the port's scoring of the same weights
    from a ``step_<n>.pt`` (which test_proc_test_matches_jax_evaluate
    holds to JAX ``trainer.evaluate``)."""
    fix_noise(monkeypatch)
    over = TEST + [f"task.load_dir={corpus}", "model.mode_estimator=mlp"]
    variables = _variables("mlp")
    jax_run = str(tmp_path / "jax")
    for step, v in ((2, variables), (5, _variables("mlp", seed=2))):
        jtrainer.save_checkpoint(jax_run, jsynth.TrainState(
            v["params"], {"constants": v["constants"]}, None, 0, None), step, with_opt=False)
    with open(os.path.join(jtrainer._ckpt_dir(jax_run), "BEST"), "w") as f:
        f.write("2\t0.5")
    os.makedirs(os.path.join(jax_run, "codes", "torch_fdtd_string_tpu"))
    ttrainer.save_checkpoint(str(tmp_path / "pt"), load_jax_variables(
        tsynth.build_model(tcompose(trun.CONFIG_DIR, over)), variables), 2)
    tables = {}
    for name, ckpt in (("from_jax", jax_run), ("from_pt", str(tmp_path / "pt"))):
        trun.main(over + [f"task.ckpt_dir={ckpt}", f"task.root_dir={tmp_path}",
                          f"task.save_name={name}"])
        tables[name] = _table(os.path.join(tmp_path, name, "score", "output.txt"))
    (h1, ids1, rows1), (h2, ids2, rows2) = tables.values()
    assert h1 == h2 and ids1 == ids2 and len(ids1) == 13 and np.array_equal(rows1, rows2)


def test_dataset_and_loader_match_jax(corpus):
    """The same items in the same order (sorted string ids, then x_ids),
    array for array, and the same batches; x_stride keeps every s-th
    column."""
    for stride in (1, 2):
        jds = jdata.Testset(corpus, NAME, x_stride=stride)
        tds = tdata.Testset(corpus, NAME, x_stride=stride)
        assert len(tds) == len(jds) == 3 * 4 // stride and tds.x_ids == jds.x_ids
        assert tds.tgt_list == jds.tgt_list
        for i in range(len(tds)):
            a, b = jds[i], tds[i]
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), key)
    jb = list(jdata.DataLoader(jdata.Testset(corpus, NAME), 8))
    tb = list(tdata.DataLoader(tdata.Testset(corpus, NAME), 8))
    assert [len(b["target"]) for b in tb] == [len(b["target"]) for b in jb] == [8, 4]
    for a, b in zip(jb, tb):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], key)


def test_trim_and_loader_options(corpus):
    """A trimmed item is a window of the target with its ``t``; the loader
    shuffles from its seed and drops a short last batch on request."""
    full = tdata.GenericDataset(corpus, NAME, split="valid")
    trimmed = tdata.GenericDataset(corpus, NAME, split="valid", trim=1000, seed=3)
    a, b = full[1], trimmed[1]
    assert b["target"].shape == (1000,) and b["t"].shape[0] == 1000
    st = int(np.argmin(np.abs(a["t"][:, 0] - b["t"][0, 0])))
    np.testing.assert_array_equal(b["target"], a["target"][st:st + 1000])
    np.testing.assert_array_equal(b["analytic"], a["analytic"][st:st + 1000])
    ds = tdata.Testset(corpus, NAME)
    order = [b["x"] for b in tdata.DataLoader(ds, 5, shuffle=True, seed=4)]
    again = [b["x"] for b in tdata.DataLoader(ds, 5, shuffle=True, seed=4)]
    assert all(np.array_equal(x, y) for x, y in zip(order, again))
    assert sorted(np.concatenate(order).tolist()) == sorted(
        np.concatenate([b["x"] for b in tdata.DataLoader(ds, 5)]).tolist())
    kept = list(tdata.DataLoader(ds, 5, drop_last=True))
    assert [len(b["x"]) for b in kept] == [5, 5] and len(tdata.DataLoader(ds, 5, drop_last=True)) == 2


def test_dataset_skips_unreadable_parameters(tmp_path, corpus):
    """A truncated parameters.npz drops its item from the scan."""
    shutil.copytree(os.path.join(corpus, NAME), str(tmp_path / NAME))
    first = sorted(os.listdir(tmp_path / NAME / "test"))[0]
    with open(tmp_path / NAME / "test" / first / "parameters.npz", "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    ds = tdata.Testset(str(tmp_path), NAME)
    assert len(ds) == 2 * 4 and all(first not in p for p in ds.tgt_list)
    with pytest.raises(FileNotFoundError):
        tdata.Testset(str(tmp_path), "no-such-corpus")


def test_make_splits_matches_the_root_tool(tmp_path, corpus):
    """The port's make_splits assigns each item as the repository's
    tools/make_splits.py does."""
    flat = tmp_path / "flat"
    for split in ("train", "valid", "test"):
        for d in glob.glob(os.path.join(corpus, NAME, split, "*")):
            shutil.copytree(d, str(flat / os.path.basename(d)))
    twin = tmp_path / "twin"
    shutil.copytree(str(flat), str(twin))
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_splits.py"), str(twin),
                    "1", "2"], check=True, capture_output=True)
    make_splits(str(flat), valid_n=1, test_n=2)
    for split in ("train", "valid", "test"):
        assert sorted(os.listdir(flat / split)) == sorted(os.listdir(twin / split))


def test_checkpoint_round_trip_and_best_marker(tmp_path):
    """step_<n>.pt holds parameters and constants; the latest step wins,
    or the one a BEST marker names; a model of another width refuses it."""
    args = tcompose(trun.CONFIG_DIR, TEST)
    a = tsynth.build_model(args, torch.Generator().manual_seed(1))
    b = tsynth.build_model(args, torch.Generator().manual_seed(2))
    run = str(tmp_path / "run")
    ttrainer.save_checkpoint(run, b, 2)
    ttrainer.save_checkpoint(run, a, 10)
    with pytest.raises(FileNotFoundError):
        ttrainer.latest_checkpoint(str(tmp_path / "none"))
    assert ttrainer.latest_checkpoint(run).endswith("step_10.pt")
    with open(os.path.join(ttrainer._ckpt_dir(run), "BEST"), "w") as f:
        f.write("2\t0.5")
    best = ttrainer.latest_checkpoint(run, prefer_best=True)
    assert best.endswith("step_2.pt")
    c = tsynth.build_model(args, torch.Generator().manual_seed(3))
    assert ttrainer.load_checkpoint(best, c) == 2
    for k, v in b.state_dict().items():
        assert torch.equal(c.state_dict()[k], v), k
    ckpt = torch.load(best, weights_only=True)
    assert sorted(ckpt["constants"]) == ["estimator.rff.N", "rff.N"]
    wider = tsynth.build_model(tcompose(trun.CONFIG_DIR, TEST + ["model.embed_dim=16"]))
    with pytest.raises(RuntimeError):
        ttrainer.load_checkpoint(best, wider)


def test_convert_is_strict():
    """A missing leaf, an extra leaf or a wrong shape raises."""
    variables = _variables("mlp")
    model = tsyn.Synthesizer(**SMALL)
    load_jax_variables(model, variables)
    missing = jax.tree.map(lambda x: x, variables)
    del missing["params"]["DMSPCore_0"]["AMBlock_0"]["gain_in"]
    with pytest.raises(ValueError, match="no leaf"):
        state_dict_from_jax(model, missing)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["DMSPCore_0"]["noise_env_gain"] = np.float32(1.0)
    with pytest.raises(ValueError, match="no place"):
        state_dict_from_jax(model, extra)
    with pytest.raises(ValueError, match="no leaf"):  # physics has no estimator leaves
        state_dict_from_jax(tsyn.Synthesizer(**SMALL, amp_adaptive_noise=True), variables)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(tsyn.Synthesizer(**dict(SMALL, n_bands=11)), variables)
    with pytest.raises(ValueError, match="no place"):
        state_dict_from_jax(tsyn.Synthesizer(**SMALL, mode_estimator="physics"), variables)


@pytest.mark.parametrize("override", [
    "task.plot=true", "task.plot_test_video=true",
    pytest.param("proc.train=true task.plot=true", id="proc.train=true")])
def test_unported_options_raise(override, tmp_path, monkeypatch):
    """The figure options need matplotlib: on a host without it each
    raises an ImportError naming the option, before any work."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    option = override.split()[-1].split("=")[0]
    with pytest.raises(ImportError, match=f"pass {option}=false"):
        trun.main(TEST + override.split() + [f"task.root_dir={tmp_path}", "task.save_name=x",
                                             f"task.load_dir={tmp_path}"])


def test_proc_test_without_a_card_raises(tmp_path, monkeypatch):
    """proc.test asks for the card unless proc.cpu=true."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = [o for o in TEST if o != "proc.cpu=true"]
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        trun.main(over + [f"task.root_dir={tmp_path}", "task.save_name=x",
                          f"task.load_dir={tmp_path}"])
