"""The port's fused nsynth-like dataset path against the JAX package's.

Both packages' ``tasks/simulate.run`` generate the same nsynth-like batch
in this process with ``task.fuse_preprocess`` on (the config's default),
from the same seed, and write the DMSP training layout into
``<save_dir>-prep/``.  On the CPU the JAX package runs its scan engine and
its jnp post-processing; the port runs the plain version of its bucketed
string step and its PyTorch post-processing.  In float64 both take the
host ``build_processed`` path.
"""

import glob
import json
import os

import numpy as np

from chip_smoke import PREP_KEYS, PREP_KEYS_CORPUS
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils import wav as wavio
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")
# the overrides of test_pipeline.py::test_fused_preprocess_matches_classic
BASE = [
    "experiment=nsynth-like", "task.num_samples=2", "task.batch_size=2",
    "task.length=0.1", "task.chunk_length=0.1", "task.randomize_name=false",
    "task.save_x_stride=4", "task.process_Nx=64", "proc.cpu=true",
]
CORPUS = ["task.save=false", "task.save_modal=false", "task.save_output_wav=false"]
# the draws, copied into every item as they are
DRAWS = ("kappa", "alpha", "f0", "pos", "T60", "p_a", "target_f0", "x_B", "v_B",
         "F_B", "wid_B", "ph0_B", "ph1_B", "x_H", "v_H", "u_H", "w_H", "M_H",
         "a_H", "bow_mask", "hammer_mask", "pluck_mask", "Nx_t", "Nx_l")


def _run(tag, tmp_path, overrides, iters=1):
    compose, sim, configs = {"jax": (jcompose, jsim, JAX_CONFIG_DIR),
                             "torch": (tcompose, tsim, trun.CONFIG_DIR)}[tag]
    d = tmp_path / tag
    d.mkdir()
    sim.run(compose(configs, overrides), str(d), "pluck", iters)
    return str(d)


def _items(d):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "*-*"))
                  if os.path.isdir(p))


def _stats(d):
    with open(os.path.join(d, "skip_stats.json")) as f:
        stats = json.load(f)
    return stats["batches"] if isinstance(stats, dict) else stats


def _meta(d):
    with open(os.path.join(d, "_gen_meta.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _check_layout(jdir, tdir):
    """Same run-dir and -prep items, file names, npz keys and dtypes,
    identical draws, ``x``, provenance and skips."""
    assert _items(tdir) and _items(jdir + "-prep") == _items(tdir + "-prep")
    assert _items(jdir) == _items(tdir)
    for item in _items(tdir):
        assert sorted(os.listdir(os.path.join(jdir, item))) == sorted(
            os.listdir(os.path.join(tdir, item)))
    assert _meta(jdir + "-prep") == _meta(tdir + "-prep")
    assert _stats(jdir) == _stats(tdir)
    out = {}
    for item in _items(tdir + "-prep"):
        jp, tp = (os.path.join(d + "-prep", item) for d in (jdir, tdir))
        assert sorted(os.listdir(jp)) == sorted(os.listdir(tp))
        jz, tz = np.load(os.path.join(jp, "parameters.npz")), np.load(
            os.path.join(tp, "parameters.npz"))
        assert sorted(jz.files) == sorted(tz.files)
        for key in jz.files:
            assert jz[key].dtype == tz[key].dtype and jz[key].shape == tz[key].shape, key
        for key in DRAWS:
            if key in jz.files:
                np.testing.assert_array_equal(jz[key], tz[key], err_msg=key)
        np.testing.assert_array_equal(jz["x"], tz["x"])
        out[item] = (jp, tp, jz, tz)
    return out


def _wav(path):
    return np.asarray(wavio.read(path)[0], np.float64).reshape(-1)


def test_fused_single_matches_jax(tmp_path):
    """float32: mode data at the bounds of test_pipeline.py:312-317, the
    wavs over the first 256 samples within the f32 kernel bounds plus the
    f16 rounding of the kept columns on both sides (5e-4 of the peak each),
    and the key set chip_smoke.py checks on the card."""
    jdir, tdir = _run("jax", tmp_path, BASE), _run("torch", tmp_path, BASE)
    items = _check_layout(jdir, tdir)
    assert len(items) == 2
    for item, (jp, tp, jz, tz) in items.items():
        assert sorted(tz.files) == sorted(PREP_KEYS)
        np.testing.assert_allclose(tz["mode_freq"], jz["mode_freq"], rtol=1e-6)
        np.testing.assert_allclose(tz["mode_amps"], jz["mode_amps"], rtol=1e-4,
                                   atol=1e-8)
        np.testing.assert_allclose(tz["u0"], jz["u0"], rtol=0, atol=3e-3 * np.abs(jz["u0"]).max())
        np.testing.assert_allclose(tz["gain"], jz["gain"], rtol=1e-3)
        np.testing.assert_allclose(tz["sig0"], jz["sig0"], rtol=1e-6)
        np.testing.assert_allclose(tz["uout"][:256], jz["uout"][:256], rtol=0,
                                   atol=2e-4 * np.abs(jz["uout"][:256]).max())
        assert len(glob.glob(os.path.join(tp, "ut-*.wav"))) == 16
        for name in sorted(os.listdir(jp)):
            if not name.endswith(".wav"):
                continue
            wj, wt = _wav(os.path.join(jp, name)), _wav(os.path.join(tp, name))
            assert wj.shape == wt.shape, name
            # the f32 state bound (6e-4 of scale) plus each package's f16
            # rounding of the kept columns (5e-4 of the peak each)
            err = np.abs(wt[:256] - wj[:256]).max()
            assert err <= (6e-4 + 2 * 5e-4) * np.abs(wj).max() + 1e-7, (item, name, err)
    with open(os.path.join(tdir, "skip_stats.json")) as f:
        stats = json.load(f)
    # every item from the device path: none through the host build
    assert stats["save_timing"]["assemble"]["n"] == 2
    assert "host_build" not in stats["save_timing"]
    assert stats["width_spread"][0] < 32 and stats["link_bytes"] > 0


def test_fused_double_matches_jax(tmp_path):
    """float64: both packages pull each item's native-width state as f32 and
    run the host build_processed, so every array agrees to 1e-9 of its
    scale (zout to max(|zout|, |uout|), as the f64 slice tests measure z)
    and every wav to one PCM_24 step."""
    over = BASE + ["task.precision=double", "task.length=0.02"]
    jdir, tdir = _run("jax", tmp_path, over), _run("torch", tmp_path, over)
    items = _check_layout(jdir, tdir)
    for item, (jp, tp, jz, tz) in items.items():
        for key in jz.files:
            w, g = jz[key].astype(np.float64), tz[key].astype(np.float64)
            scale = np.abs(w).max() if w.size else 0.0
            if key == "zout":
                scale = max(scale, np.abs(jz["uout"]).max())
            assert np.abs(g - w).max(initial=0.0) <= 1e-9 * scale, (item, key)
        for name in sorted(os.listdir(jp)):
            if name.endswith(".wav"):
                err = np.abs(_wav(os.path.join(tp, name)) - _wav(os.path.join(jp, name)))
                assert err.max() <= 1.5 / 8388607, (item, name, err.max())
    with open(os.path.join(tdir, "skip_stats.json")) as f:
        timing = json.load(f)["save_timing"]
    assert timing["host_build"]["n"] == len(items) and "assemble" not in timing


def test_x_offset_jitter_varies_kept_columns(tmp_path):
    """Twin of test_pipeline.py::test_x_offset_jitter_varies_kept_columns
    (seed 11, B=1, three batches, 0.05 s): each item stores 16 columns at a
    stride-4 offset drawn per batch from default_rng([seed, 0x0FF5E7])."""
    seed = 11
    out = _run("torch", tmp_path, [
        "experiment=nsynth-like", f"proc.seed={seed}", "task.batch_size=1",
        "task.length=0.05", "task.chunk_length=0.05", "task.randomize_name=false",
        "task.save_x_stride=4", "task.process_Nx=64", "proc.cpu=true",
        "task.save_x_offset_jitter=true"] + CORPUS, iters=3)
    xg = np.linspace(0, 1, 64)
    exp_rng = np.random.default_rng([seed, 0x0FF5E7])
    offsets = []
    for it in range(3):
        exp_off = int(exp_rng.integers(4))  # drawn whether or not it is written
        item = out + f"-prep/{it}-0/parameters.npz"
        if not os.path.exists(item):
            continue
        x = np.load(item)["x"][0]
        assert x.shape == (16,)
        off = int(np.argmin(np.abs(xg - x[0])))
        np.testing.assert_array_equal(x, xg[off::4])
        assert off == exp_off
        offsets.append(off)
        assert len(glob.glob(out + f"-prep/{it}-0/ut-*.wav")) == 16
    assert len(set(offsets)) > 1, offsets
    assert _meta(out + "-prep")[0]["save_x_offset_jitter"] is True


def test_corpus_mode_skips_readout_artifacts(tmp_path):
    """Twin of test_pipeline.py::test_corpus_mode_skips_readout_artifacts
    with save_compact_params: no run-dir items, no readout copies, the
    compact key set of chip_smoke.py's corpus phase (the JAX package's, on
    the same run), and no readout pulled from the device."""
    over = BASE + CORPUS + ["task.save_compact_params=true", "task.length=0.05",
                            "task.chunk_length=0.05"]
    jdir, tdir = _run("jax", tmp_path, over), _run("torch", tmp_path, over)
    assert not glob.glob(tdir + "/0-*")
    items = sorted(d for d in glob.glob(tdir + "-prep/*") if os.path.isdir(d))
    assert len(items) == 2
    for d in items:
        keys = sorted(np.load(os.path.join(d, "parameters.npz")).files)
        jkeys = sorted(np.load(os.path.join(
            jdir + "-prep", os.path.basename(d), "parameters.npz")).files)
        assert keys == jkeys == sorted(PREP_KEYS_CORPUS)
        assert len(glob.glob(d + "/ut-*.wav")) == 16
        assert not glob.glob(d + "/ua-*.wav") and os.path.exists(d + "/vt.wav")
    with open(os.path.join(tdir, "skip_stats.json")) as f:
        stats = json.load(f)
    # the post-processed arrays and the (B,) NaN/silence flags, nothing else
    B, Nt, K = 2, 2400, 16
    n_frames = Nt // 480 + 1  # the 10 ms hop of the YIN track
    post = B * Nt * K * 2 + B * (Nt - 1) * 2 + B * n_frames * 4 + B * 4
    assert stats["link_bytes"] == post + 2 * B


def test_host_path_when_width_spread_reaches_G(tmp_path, monkeypatch):
    """A batch whose width spread reaches G is post-processed on the host
    from each item's native-width state: same layout and keys, the kept
    columns within the f16 rounding of the device path."""
    over = BASE + CORPUS + ["task.length=0.05", "task.chunk_length=0.05"]
    dev = _run("torch", tmp_path, over)
    monkeypatch.setattr(tsim, "POSTPROC_G", 0)  # every spread reaches it
    host_dir = tmp_path / "host"
    host_dir.mkdir()
    tsim.run(tcompose(trun.CONFIG_DIR, over), str(host_dir), "pluck", 1)
    host = str(host_dir)
    with open(os.path.join(host, "skip_stats.json")) as f:
        timing = json.load(f)["save_timing"]
    assert timing["host_build"]["n"] == 2 and "assemble" not in timing
    for item in _items(dev + "-prep"):
        a, b = (os.path.join(d + "-prep", item) for d in (dev, host))
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        za, zb = np.load(os.path.join(a, "parameters.npz")), np.load(
            os.path.join(b, "parameters.npz"))
        assert sorted(za.files) == sorted(zb.files)
        np.testing.assert_allclose(za["mode_freq"], zb["mode_freq"], rtol=1e-6)
        for xi in range(16):
            wa, wb = _wav(f"{a}/ut-{xi}.wav"), _wav(f"{b}/ut-{xi}.wav")
            assert np.abs(wa - wb).max() <= 5e-4 * np.abs(wb).max() + 1e-7, xi
