"""Preset-driven strings in the port against the JAX package:
``tasks/preprocess_data.py`` and ``task.load_config``.

A seeded synthetic recording (a tone gliding from 196 to 233 Hz, struck
three times) goes through both packages' ``preprocess_data.process``; the
presets it writes go through both packages' ``_load_presets`` on the same
draws, and drive one whole bowed float64 run in each package, on the
pattern of ``test_torch_simulate_excitation.py``.  ``experiment=all-fixed``
runs as configured (float64 on the CPU) with its plots off.
"""

import os
import sys
import shutil

import numpy as np
import pytest
import torch

from test_torch_simulate import BASE, CONFIG_DIR, _bundles, _check_common, _items
from test_torch_simulate_excitation import _check_excitation, _run_both, _scale
from torch_fdtd_string_tpu.tasks import preprocess_data as jpre
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.tasks import preprocess_data as tpre
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils import wav as wavio
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

SR = 48000
PRESETS = ("string-f0.npy", "bow-F_b.npy", "hammer-v_H.npy")
TRACES = ("v_r_out", "F_H_out", "u_H_out")


def synthetic_recording(path, length=0.5, seed=0, sr=SR):
    """``path/input.wav``: a tone gliding linearly from 196 to 233 Hz, its
    envelope restarted (decaying at 8 /s) at 0, 1/3 and 2/3 of the length,
    with -60 dB of seeded noise."""
    n = int(length * sr)
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(196.0 + 37.0 * t / length) / sr
    env = np.zeros(n)
    for on in (0.0, length / 3, 2 * length / 3):
        i = int(on * sr)
        env[i:] = np.exp(-8.0 * np.arange(n - i) / sr)
    x = 0.5 * env * np.sin(phase) + 1e-3 * np.random.default_rng(seed).standard_normal(n)
    os.makedirs(path, exist_ok=True)
    wavio.write(os.path.join(path, "input.wav"), x, sr, "PCM_24")


@pytest.fixture(scope="module")
def presets(tmp_path_factory):
    """The port's presets of the synthetic recording: ``<root>/rec``."""
    root = tmp_path_factory.mktemp("presets")
    synthetic_recording(str(root / "rec"))
    tpre.process(str(root), "rec")
    return root / "rec"


def test_preprocess_data_matches_jax(tmp_path):
    """Both packages' ``process(plot=False)`` on the same recording: the
    three presets equal at 1e-9 of their scale, ``sine-f0.wav`` equal, the
    f0 track within the glide and the strikes at 1/3 and 2/3 found (the
    one at 0 has no frame before it to rise from)."""
    for tag in ("jax", "torch"):
        synthetic_recording(str(tmp_path / tag / "rec"))
    want = jpre.process(str(tmp_path / "jax"), "rec", plot=False)
    got = tpre.process(str(tmp_path / "torch"), "rec")
    for name, g, w in zip(PRESETS, got, want):
        jf, tf = (np.load(tmp_path / tag / "rec" / name) for tag in ("jax", "torch"))
        assert tf.shape == jf.shape == (SR // 2,) and np.isfinite(tf).all()
        assert np.abs(tf - jf).max() <= 1e-9 * _scale(jf), name
        np.testing.assert_array_equal(g, tf)
    ja, ta = (wavio.read(str(tmp_path / tag / "rec" / "sine-f0.wav"))[0]
              for tag in ("jax", "torch"))
    np.testing.assert_array_equal(ta, ja)
    f0, force, hammer = got
    assert 190.0 < f0.min() and f0.max() < 240.0
    assert (force > 0).mean() > 0.9
    assert int(hammer.sum()) == 2


def test_preprocess_data_plot_raises(tmp_path, monkeypatch):
    """Without matplotlib ``plot=True`` (the default) raises before any
    work."""
    synthetic_recording(str(tmp_path / "rec"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot=false"):
        tpre.process(str(tmp_path), "rec")
    assert not any(n.endswith(".npy") for n in os.listdir(tmp_path / "rec"))


def _draws(model_name, length, batch_size=3):
    """One nsynth-like batch's draws (seed 16) and the task constants."""
    args = tcompose(CONFIG_DIR, BASE + [f"task.length={length}"])
    kw = tsim.task_kwargs(args.task)
    theta_t = kw.pop("theta_t")
    draws = tsim.draw_params(model_name, SR, theta_t, length, batch_size,
                             args.task.f0_inf, args.task.alpha_inf, args.task.lambda_c,
                             rng=np.random.default_rng(16), **kw)
    return draws[:3], theta_t, args.task


@pytest.mark.parametrize("length", [0.3, 0.6], ids=["cut", "padded"])
@pytest.mark.parametrize("model_name", ["pluck", "bow", "hammer"])
def test_load_presets_matches_jax(presets, model_name, length):
    """Both packages' ``_load_presets`` on the same draws: every field of
    the string, the bow and the hammer equal, the presets cut (0.3 s) or
    edge-padded (0.6 s) to the run's length; ``target_f0`` is the preset,
    ``f0`` the preset over each string's w0, and the allocation holds."""
    total = int(length * SR)
    (js, jb, jh), _, _ = _draws(model_name, length)
    (ts, tb, th), theta_t, task = _draws(model_name, length)
    jsim._load_presets(str(presets), total, js, jb, jh, 1.0 / SR)
    tsim._load_presets(str(presets), total, ts, tb, th, 1.0 / SR)
    for jobj, tobj in ((js, ts), (jb, tb), (jh, th)):
        for field, w in vars(jobj).items():
            g = getattr(tobj, field)
            assert np.asarray(g).dtype == np.asarray(w).dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    f0 = np.load(presets / "string-f0.npy")
    want = f0[:total] if len(f0) >= total else np.pad(f0, (0, total - len(f0)), mode="edge")
    np.testing.assert_array_equal(ts.target_f0, np.broadcast_to(want, ts.target_f0.shape)
                                  .astype(np.float32))
    assert (ts.f0 < ts.target_f0).all()  # divided by w0 > 1
    force = np.load(presets / "bow-F_b.npy")
    np.testing.assert_array_equal(tb.F_b[:, :min(total, len(force))],
                                  np.broadcast_to(force[:total], (3, min(total, len(force))))
                                  .astype(np.float32))
    tsim.check_allocation(ts, 1.0 / SR, theta_t, task.lambda_c, task.f0_inf)


def test_preset_below_the_allocation_raises(tmp_path):
    """A preset f0 whose grid needs more points than the batch allocates
    from ``task.f0_inf`` is refused (the JAX package runs it unchecked).
    Below ``f0_inf`` is not enough: the allocation is sized for a string
    without stiffness at ``alpha_inf``, and stiffness and a larger alpha
    shrink the grids, so the preset here sits at 5 Hz."""
    np.save(tmp_path / "string-f0.npy", np.full(SR // 10, 5.0))
    (ts, tb, th), theta_t, task = _draws("pluck", 0.1)
    tsim._load_presets(str(tmp_path), SR // 10, ts, tb, th, 1.0 / SR)
    with pytest.raises(ValueError, match="task.f0_inf"):
        tsim.check_allocation(ts, 1.0 / SR, theta_t, task.lambda_c, task.f0_inf)
    args = tcompose(CONFIG_DIR, BASE + ["task.length=0.1", f"task.load_config={tmp_path}"])
    with pytest.raises(ValueError, match="task.f0_inf"):
        tsim.run(args, str(tmp_path / "run"), "pluck", 1)


def test_preset_bow_run_double_matches_jax(presets, tmp_path):
    """A whole bowed float64 run driven by the presets in both packages:
    every field at 1e-9 of its own scale (as
    test_simulate_excitation_double_matches_jax), ``target_f0`` the preset
    and the bow force the preset's."""
    over = BASE + ["task.num_samples=2", "task.batch_size=2", "task.length=0.005",
                   "task.chunk_length=0.005", "proc.seed=16", "task.relative_order=12",
                   "task.precision=double", f"task.load_config={presets}"]
    jdir, tdir = _run_both(tmp_path, "bow", over)
    _check_common(jdir, tdir)
    _check_excitation(jdir, tdir, "bow")
    f0 = np.load(presets / "string-f0.npy")[:240]
    force = np.load(presets / "bow-F_b.npy")[:240]
    for item in _items(tdir):
        st = np.load(os.path.join(tdir, item, "string_params.npz"))
        np.testing.assert_array_equal(st["target_f0"], f0)
        bow = np.load(os.path.join(tdir, item, "bow_params.npz"))
        np.testing.assert_array_equal(bow["F_B"], force)
        jz, tz = _bundles(jdir, tdir, item)
        assert np.abs(tz["uout"]).max() > 0
        for key in ("state_u", "state_z", "uout", "zout") + TRACES:
            assert jz[key].shape == tz[key].shape and tz[key].dtype == np.float64, key
            err = np.abs(jz[key] - tz[key]).max()
            assert err <= 1e-9 * _scale(jz[key]), (item, key, err / _scale(jz[key]))


def test_run_preset_needs_a_card(presets, tmp_path, monkeypatch):
    """``task.load_config`` through ``run.main`` runs on the card unless
    ``proc.cpu=true``; without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = [o for o in BASE if o != "proc.cpu=true"] + [
        "task.length=0.01", f"task.load_config={presets}", f"task.root_dir={tmp_path}",
        "task.save_name=preset", "model.excitation=bow"]
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        trun.main(over)


def test_all_fixed_runs(tmp_path):
    """``experiment=all-fixed`` with its plots off: float64 on the CPU as
    configured (``proc.cpu: true``), its fixed string, equal to the JAX
    package's run at 1e-9 of each field's scale.  Both at
    ``task.relative_order=12``, where the JAX engine's loop converges to
    float64 too (test_simulate_excitation_double_matches_jax)."""
    over = ["experiment=all-fixed", "task.plot=false", "task.length=0.005",
            "task.chunk_length=0.005", "task.relative_order=12"]
    jdir, tdir = _run_both(tmp_path, "pluck", over)
    assert _items(jdir) == _items(tdir) == ["0-0"]
    st = np.load(os.path.join(tdir, "0-0", "string_params.npz"))
    np.testing.assert_allclose(st["target_f0"], 55.0)
    jz, tz = _bundles(jdir, tdir, "0-0")
    for key in ("state_u", "state_z", "uout", "zout"):
        assert tz[key].dtype == np.float64 and jz[key].shape == tz[key].shape, key
        # state_z against max(|state_z|, |state_u|), as test_simulate_double_matches_jax
        scale = _scale(jz[key]) if key != "state_z" else max(_scale(jz[key]),
                                                            _scale(jz["state_u"]))
        err = np.abs(jz[key] - tz[key]).max()
        assert err <= 1e-9 * scale, (key, err / scale)
    root = tmp_path / "cli"
    trun.main(["experiment=all-fixed", "task.plot=false", "task.length=0.005",
               f"task.root_dir={root}", "task.save_name=af"])
    assert os.path.exists(root / "af" / "0-0" / "simulation.npz")
    assert os.path.exists(root / "af" / "cpu_time.txt")
    shutil.rmtree(root)
