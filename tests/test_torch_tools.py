"""The port's last five command-line tools (``torch_fdtd_string_tpu_torch/tools``).

``yin_accuracy`` scores the same tones as the JAX tool (its loop run here
over the JAX package's modules: the JAX tool itself writes into the
repository), ``attrition_study`` re-runs dumped draws through the float64
engine and writes strict JSON, ``prebuild_cache`` writes the host caches
the trainer then loads, equal to the trainer's own build, and the two
sweeps print strict JSON lines on the CPU and raise without a card unless
asked for the CPU.  The tools' corpus also serves the check that a run's
code snapshot scores it whether the snapshot holds the config tree (since
the port has its own) or not (one written before).  The modal solution's roots come from the dense sweep
here (``FDTD_NO_ROOT_TABLE=1``, both packages), so that no test pays for a
root table.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.core import analytic as janalytic
from torch_fdtd_string_tpu.ops.modal import modal_synth_nyquist_np as jsynth_np
from torch_fdtd_string_tpu.utils.frequency import compute_harmonic_parameters as jharmonic
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.data import dataset as tdata
from test_torch_dmsp_modules import SMALL
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.tools import (attrition_study, batch_sweep, length_sweep,
                                               prebuild_cache, yin_accuracy)
from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits
from torch_fdtd_string_tpu_torch.utils.config import compose

NAME = "corpus-prep"
# three plucked strings of 50 ms, four kept columns each, split 1 / 1 / 1
CORPUS = ["experiment=nsynth-like", "task.num_samples=3", "task.batch_size=3",
          "task.length=0.05", "task.chunk_length=0.05", "task.save_x_stride=16",
          "task.process_Nx=64", "task.save=false", "task.save_output_wav=false",
          "proc.cpu=true"]


def _strict(text):
    """JSON that refuses NaN and infinities."""
    def bad(name):
        raise ValueError(f"non-finite number {name}")

    return json.loads(text, parse_constant=bad)


@pytest.fixture(autouse=True)
def no_root_table(monkeypatch):
    monkeypatch.setenv("FDTD_NO_ROOT_TABLE", "1")


def jax_tone_rows(n, sr=48000, seed=0):
    """The JAX tool's loop (tools/yin_accuracy.py:23-60) over the JAX
    package's modules."""
    rng = np.random.default_rng(seed)
    rows = []
    Nt, Na = sr, 512
    for _ in range(n):
        f0 = float(rng.uniform(98.0, 440.0))
        kr = float(rng.uniform(0.01, 0.03))
        t60 = np.array([[100.0, rng.uniform(10, 25)], [1000.0, rng.uniform(10, 30)]])
        p_x = float(rng.uniform(0.2, 0.8))
        x = np.linspace(0, 1, Na)
        u0 = np.where(x < p_x, x / max(p_x, 1e-6), (1 - x) / max(1 - p_x, 1e-6)) * 0.01
        _, mode_freq, mode_amps = janalytic.lossy_stiff_string(
            u0, f0, kr, t60, Nt, Na, sr, strict=False, return_field=False)
        f_true = float(mode_freq[0]) * sr / (2 * np.pi)
        wav = jsynth_np(np.tile(mode_freq[None, :], (Nt, 1)), mode_amps.T[Na // 3:Na // 3 + 1],
                        np.ones(Nt), sr)[:, 0]
        wav = wav / (np.sqrt(np.mean(wav**2)) + 1e-12)
        f_est = float(np.median(jharmonic(wav, sr)["f0"]))
        rows.append((f0, kr, f_true, f_est, abs(f_est - f_true)))
    return rows


def test_yin_accuracy_scores_the_jax_tools_tones(tmp_path, capsys):
    out = tmp_path / "yin" / "yin_accuracy.md"
    rows = yin_accuracy.main(["--n", "3", "--out", str(out)])
    want = jax_tone_rows(3)
    for got, w in zip(rows, want):
        assert got[:2] == w[:2]  # the same draws
        np.testing.assert_allclose(got[2:4], w[2:4], rtol=1e-12)
        assert got[4] <= 0.01  # Hz, against the exact mode-1 frequency
    md = out.read_text()
    assert md == yin_accuracy.table(rows) and md in capsys.readouterr().out
    assert md.count("\n| ") == 5 and "3 modal tones" in md


def _dump_run(root, n=2):
    """A classic run of ``n`` plucked strings of 5 ms with every draw
    dumped; returns its directory."""
    args = compose(trun.CONFIG_DIR, [
        "experiment=nsynth-like", f"task.num_samples={n}", f"task.batch_size={n}",
        "task.length=0.005", "task.fuse_preprocess=false", "task.dump_draws=true",
        "task.save=false", "task.plot=false", "task.randomize_name=false", "proc.cpu=true"])
    tsim.run(args, str(root), "pluck", 1)
    return str(root)


def test_attrition_study_on_two_draws(tmp_path, capsys):
    """Two dumped draws, the second marked skipped as a NaN first pass
    would mark it, through the float64 engine on the CPU: one skip row,
    one control row, each with its draw's values, strict JSON."""
    run = _dump_run(tmp_path / "run")
    draws = attrition_study.load_draws(run)
    assert [str(d["why"]) for d in draws] == ["kept", "kept"]
    path = os.path.join(run, draws[1]["_file"])
    np.savez(path, **{k: ("nan" if k == "why" else v) for k, v in draws[1].items()
                      if k != "_file"})
    out = tmp_path / "attrition.json"
    record = attrition_study.main(["--run", run, "--controls", "3", "--length", "0.005",
                                   "--out", str(out), "--cpu"])
    on_disk = _strict(out.read_text())
    assert on_disk == record
    assert (record["n_draws_total"], record["n_skipped"], record["length_s"]) == (2, 1, 0.005)
    assert "port's float64 scan engine" in record["engine"]
    assert [(r["file"], r["group"]) for r in record["rows"]] == [
        (draws[1]["_file"], "skip"), (draws[0]["_file"], "control")]
    for r, d in zip(record["rows"], (draws[1], draws[0])):
        assert r["alpha"] == round(float(d["alpha"]), 3)
        assert r["f0"] == round(float(d["f0"][2]), 2)
        assert r["p_a"] == round(float(d["p_a"]), 4)
        assert r["reference_nan"] is False
    assert "float64 NaN on 0/1 of the skips; 0/1 of the kept controls" in (
        capsys.readouterr().out)
    with pytest.raises(FileNotFoundError):
        attrition_study.main(["--run", str(tmp_path), "--cpu"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A fused corpus of the port's, split; returns the data directory."""
    root = tmp_path_factory.mktemp("tools_corpus")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FDTD_NO_ROOT_TABLE", "1")
        tsim.run(compose(trun.CONFIG_DIR, CORPUS), str(root / "corpus"), "pluck", 1)
    assert make_splits(str(root / NAME), valid_n=1, test_n=1) == {
        "train": 1, "valid": 1, "test": 1}
    return str(root)


def test_prebuild_cache_is_what_the_trainer_loads(corpus, capsys):
    """The caches under the names ``train`` looks for (synth-dmsp's
    settings, the tool's defaults), each equal bit for bit to the
    trainer's own build of its split, which the trainer then loads; a
    second call builds nothing."""
    args = compose(trun.CONFIG_DIR, ["experiment=synth-dmsp"])
    n_modes, block, sr = args.model.n_modes, args.model.block_size, args.task.sr
    trim = int(args.task.train_lens * sr)
    x_stride = int(args.task.get("x_stride", 1) or 1)
    tag = ttrainer.cache_tag(n_modes, block, sr, trim, x_stride)
    paths = prebuild_cache.main(["--load-name", NAME, "--data-dir", corpus])
    assert paths == [os.path.join(corpus, NAME, f"_prep_{s}_{tag}.npz")
                     for s in ("train", "valid", "test")]
    sets = (tdata.Trainset(corpus, NAME, trim=trim, x_stride=x_stride),
            tdata.Testset(corpus, NAME, split="valid", x_stride=x_stride),
            tdata.Testset(corpus, NAME, split="test", x_stride=x_stride))
    for ds, path in zip(sets, paths):
        own = ttrainer._build_host_cache(ds, n_modes, block, sr, drop=("analytic",))
        capsys.readouterr()
        loaded = ttrainer._build_host_cache(ds, n_modes, block, sr, cache_path=path,
                                            drop=("analytic",))
        assert f"loaded host cache {path}" in capsys.readouterr().out
        assert sorted(loaded) == sorted(own)
        for k, v in own.items():
            assert loaded[k].dtype == v.dtype and np.array_equal(loaded[k], v), k
    mtimes = [os.path.getmtime(p) for p in paths]
    prebuild_cache.main(["--load-name", NAME, "--data-dir", corpus])
    assert [os.path.getmtime(p) for p in paths] == mtimes
    assert capsys.readouterr().out.count("exists, skipping") == 3


@pytest.mark.parametrize("tool", [batch_sweep, length_sweep], ids=["batch", "length"])
def test_sweeps_need_a_card_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--cpu"):
        tool.main([])


def test_batch_sweep_prints_strict_json_lines(capsys):
    """One point of the plain version on the CPU (512 steps), then the
    closing line."""
    rows = batch_sweep.main(["--batches", "1", "--length", "0.011", "--reps", "1", "--cpu"])
    lines = [_strict(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0] == rows[0]
    assert (rows[0]["B"], rows[0]["length_s"], rows[0]["backend"]) == (1, 0.011, "cpu")
    assert rows[0]["audio_s_per_s"] == pytest.approx(512 / 48000 / rows[0]["wall_s"])
    assert lines[1] == {"monotone_within_10pct": True, "rates": [rows[0]["audio_s_per_s"]]}


def test_snapshots_with_and_without_configs_score_alike(corpus, tmp_path):
    """``proc.test`` of a run directory whose ``codes/`` snapshot holds the
    package's ``configs/`` (as ``run.backup_code`` writes it now) and of
    one whose snapshot lacks it (written before the port had its own
    tree): the snapshot's ``evaluate`` scores both, to the same tables."""
    over = ["experiment=synth-dmsp", "proc.cpu=true", "task.plot=false",
            "model.mode_estimator=mlp", f"task.load_dir={corpus}", f"task.load_name={NAME}",
            "task.test_batch_size=8"] + [f"model.{k}={v}" for k, v in SMALL.items()]
    model = tsynth.build_model(compose(trun.CONFIG_DIR, over),
                               generator=torch.Generator().manual_seed(0))
    tables = {}
    for tag in ("with", "without"):
        run = tmp_path / tag
        ttrainer.save_checkpoint(str(run), model, 1)
        trun.backup_code(trun.PKG_DIR, str(run))
        configs = run / "codes" / "torch_fdtd_string_tpu_torch" / "configs"
        assert (configs / "config.yaml").is_file()
        if tag == "without":
            shutil.rmtree(configs)
        args = compose(trun.CONFIG_DIR, over + [f"task.ckpt_dir={run}"])
        ttrainer.evaluate(args, str(run))
        tables[tag] = (run / "score" / "output.txt").read_text()
    assert tables["with"] == tables["without"]
    rows = [r for r in tables["with"].splitlines() if r.startswith("0-0-")]
    assert len(rows) == 4  # the test string's four kept columns
