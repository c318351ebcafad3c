"""The port's classic preprocessing against the JAX package's.

One classic ``proc.cpu=true`` run of the port (two plucked strings of 50 ms,
the nsynth-like overrides of ``test_torch_simulate.py``) is written once;
both packages' ``save_upsampled_data`` process the same item directories.
The device cosine bank ``modal_synth_nyquist`` is held against its numpy
twin and the JAX bank, the fused prep of the same draws against the
classic prep at the JAX bounds (``tests/test_pipeline.py:247-327``), and
``process``'s sharding and restart, ``run.main``'s branch and the
``utils/data.py`` helpers against the JAX ones.  The JAX package runs with
x64 on (``tests/conftest.py``), so its bank is float64 here.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simulate import BASE, CONFIG_DIR
from torch_fdtd_string_tpu.ops import modal as jmodal
from torch_fdtd_string_tpu.tasks import process_training_data as jptd
from torch_fdtd_string_tpu.utils import data as jdata
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.ops import modal as tmodal
from torch_fdtd_string_tpu_torch.tasks import process_training_data as tptd
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils import data as tdata
from torch_fdtd_string_tpu_torch.utils import wav as wavio
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

SR = 48000
CPU = torch.device("cpu")
# test_torch_simulate.py's batch, cut to 50 ms
CLASSIC = [o for o in BASE if not o.startswith(("task.length", "task.chunk_length"))] + [
    "task.length=0.05", "task.chunk_length=0.05"]
# the float32 bank against its numpy twin: one float32 product over the
# modes, summed in another order (readings ~1e-7 of scale)
NP_BOUND = 1e-5
# against the JAX bank (tests/test_utils.py:264-289)
JAX_BOUND = 2e-3


@pytest.fixture(scope="module")
def classic_run(tmp_path_factory):
    """The port's classic run: ``<root>/sim/0-0``, ``0-1``."""
    root = tmp_path_factory.mktemp("ptd")
    tsim.run(tcompose(CONFIG_DIR, CLASSIC), str(root / "sim"), "pluck", 1)
    items = sorted(glob.glob(str(root / "sim" / "0-*")))
    assert len(items) == 2
    return root, items


def _bank_inputs(seed=1, Nt=2000, n=24, Nx=16):
    """A mode set with two modes above Nyquist (pi rad/sample), a damped
    envelope and per-column amplitudes."""
    rng = np.random.default_rng(seed)
    freq = 0.005 + 0.12 * rng.random(n)
    freq[-2:] = [3.3, 4.0]
    freq_tv = freq[None, :] + 1e-4 * np.sin(np.arange(Nt) / 300.0)[:, None]
    amps = rng.standard_normal((Nx, n)).astype(np.float32) * 0.01
    damp = np.exp(-np.arange(Nt) / SR * 3.0)
    return freq_tv, amps, damp


def _torch_bank(freq_tv, amps, damp):
    out = tmodal.modal_synth_nyquist(
        torch.as_tensor(freq_tv[None], dtype=torch.float64),
        torch.as_tensor(amps[:, None, :], dtype=torch.float32),
        torch.as_tensor(damp[None, :, None], dtype=torch.float32), float(SR))
    assert out.shape == (amps.shape[0], freq_tv.shape[0], 1)
    assert out.dtype == torch.float32
    return out[:, :, 0].T.numpy()


def test_modal_synth_nyquist_matches_numpy_twin():
    """The device bank against ``modal_synth_nyquist_np`` at NP_BOUND of
    scale; the modes above Nyquist keep 1e-4 of their amplitude."""
    freq_tv, amps, damp = _bank_inputs()
    got = _torch_bank(freq_tv, amps, damp)
    ref = tmodal.modal_synth_nyquist_np(freq_tv, amps, damp, SR)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < NP_BOUND * scale, np.abs(got - ref).max() / scale
    above = _torch_bank(freq_tv[:, -2:], amps[:, -2:], damp)
    ref_above = tmodal.modal_synth_nyquist_np(freq_tv[:, -2:], amps[:, -2:] * 1e4, damp, SR)
    np.testing.assert_allclose(above, ref_above * 1e-4, rtol=0,
                               atol=NP_BOUND * np.abs(ref_above).max() * 1e-4)


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64])
def test_modal_synth_nyquist_matches_jax(jdtype):
    """Against the JAX bank at JAX_BOUND of scale, fed float32 (as its
    own test feeds it; its phase then sums in float32) or float64."""
    freq_tv, amps, damp = _bank_inputs()
    ref = np.asarray(jmodal.modal_synth_nyquist(
        jnp.asarray(freq_tv[None], jdtype), jnp.asarray(amps[:, None, :]),
        jnp.asarray(damp[None, :, None], jdtype), float(SR)))[:, :, 0].T
    got = _torch_bank(freq_tv, amps, damp)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < JAX_BOUND * scale, np.abs(got - ref).max() / scale


def _wavs(d, prefix):
    if prefix == "vt":
        return wavio.read(os.path.join(d, "vt.wav"))[0]
    paths = sorted(glob.glob(os.path.join(d, f"{prefix}-*.wav")),
                   key=lambda p: int(p.rsplit("-", 1)[1][:-4]))
    return np.stack([wavio.read(p)[0] for p in paths], axis=1)


def test_save_upsampled_data_matches_jax(classic_run, tmp_path):
    """Both packages' ``save_upsampled_data`` on the same item directory:
    the same files and ``parameters.npz`` keys; ``mode_freq`` at rtol
    1e-6, ``ut``, ``vt`` and the f0 tracks at 1e-6 of scale, ``ua`` at
    JAX_BOUND of scale, every other key at rtol 1e-6."""
    _, items = classic_run
    for item in items:
        jd, td = str(tmp_path / "jax" / os.path.basename(item)), str(
            tmp_path / "torch" / os.path.basename(item))
        assert jptd.save_upsampled_data(item, jd, SR, 64, strict=False) == 1
        assert tptd.save_upsampled_data(item, td, SR, 64, strict=False, device=CPU) == 1
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
        assert tptd.is_processed(td, 64) and jptd.is_processed(td, 64)
        jz, tz = np.load(os.path.join(jd, "parameters.npz")), np.load(
            os.path.join(td, "parameters.npz"))
        assert sorted(jz.files) == sorted(tz.files)
        np.testing.assert_allclose(tz["mode_freq"], jz["mode_freq"], rtol=1e-6)
        for key in jz.files:
            if key in ("mode_freq", "ua_f0", "ut_f0"):
                continue
            np.testing.assert_allclose(np.asarray(tz[key], np.float64),
                                       np.asarray(jz[key], np.float64), rtol=1e-6,
                                       atol=1e-12, err_msg=key)
        for key in ("ut_f0", "ua_f0"):
            np.testing.assert_allclose(tz[key], jz[key], rtol=0,
                                       atol=1e-6 * np.abs(jz[key]).max(), err_msg=key)
        for prefix, bound in (("ut", 1e-6), ("vt", 1e-6), ("ua", JAX_BOUND)):
            j, t = _wavs(jd, prefix), _wavs(td, prefix)
            assert j.shape == t.shape and np.isfinite(t).all()
            scale = np.abs(j).max()
            assert np.abs(j - t).max() <= bound * scale, (item, prefix,
                                                         np.abs(j - t).max() / scale)


def test_fused_prep_matches_classic_prep(classic_run, tmp_path):
    """The port's fused prep of the same draws against its classic prep
    (``save_upsampled_data`` of the classic items), at the bounds of the
    JAX package's tests/test_pipeline.py::test_fused_preprocess_matches_classic."""
    _, items = classic_run
    fused = [o for o in CLASSIC if o != "task.fuse_preprocess=false"] + [
        "task.fuse_preprocess=true", "task.save_x_stride=4", "task.process_Nx=64"]
    run_dir = tmp_path / "fused"
    tsim.run(tcompose(CONFIG_DIR, fused), str(run_dir), "pluck", 1)
    keep = np.arange(0, 64, 4)
    for item in items:
        name = os.path.basename(item)
        cd = str(tmp_path / "classic-prep" / name)
        tptd.save_upsampled_data(item, cd, SR, 64, strict=False, device=CPU)
        fd = str(run_dir) + f"-prep/{name}"
        assert len(glob.glob(f"{fd}/ut-*.wav")) == 16
        fz, cz = np.load(f"{fd}/parameters.npz"), np.load(f"{cd}/parameters.npz")
        np.testing.assert_allclose(fz["x"][0], cz["x"][0][keep], rtol=0, atol=0)
        np.testing.assert_allclose(fz["mode_freq"], cz["mode_freq"], rtol=1e-6)
        np.testing.assert_allclose(fz["mode_amps"], cz["mode_amps"][:, keep],
                                   rtol=1e-4, atol=1e-8)
        wf, wc = _wavs(fd, "ut"), _wavs(cd, "ut")[:, keep]
        tol = 5e-4 * np.abs(wc).max() + 1e-7
        assert np.abs(wf - wc).max() < tol, (name, np.abs(wf - wc).max(), tol)


def _ptd_overrides(root, *extra):
    return ["experiment=process_training_data", "proc.cpu=true",
            f"task.root_dir={root}", "task.result_dir=sim", "task.save_dir=prep",
            "task.Nx=16", *extra]


def test_process_shards_and_restarts(classic_run):
    """``task.data_split=2`` takes every other directory from
    ``task.split_n``; a complete item is skipped on the next call and an
    incomplete one processed again, under JAX's ``replace(result_dir,
    save_dir)`` naming."""
    root, items = classic_run
    prep = root / "prep"
    args = lambda *extra: tcompose(CONFIG_DIR, _ptd_overrides(root, *extra))
    assert tptd.process(args("task.data_split=2", "task.split_n=1")) == 1
    assert sorted(os.listdir(prep)) == ["0-1"]
    assert tptd.process(args("task.data_split=2", "task.split_n=0")) == 1
    assert sorted(os.listdir(prep)) == ["0-0", "0-1"]
    assert tptd.process(args()) == 0  # both complete: nothing to do
    os.remove(prep / "0-0" / "ua-3.wav")
    assert not tptd.is_processed(str(prep / "0-0"), 16)
    assert tptd.process(args()) == 1
    assert all(tptd.is_processed(str(prep / n), 16) for n in ("0-0", "0-1"))


def test_run_process_training_data(classic_run, monkeypatch):
    """``experiment=process_training_data`` through ``run.main`` writes the
    item layout with ``proc.cpu=true``; without it a host with no card
    raises, in ``run.main`` and in ``build_processed``'s device bank."""
    root, _ = classic_run
    trun.main(_ptd_overrides(root, "task.save_dir=prep-main"))
    for name in ("0-0", "0-1"):
        d = str(root / "prep-main" / name)
        assert tptd.is_processed(d, 16)
        z = np.load(os.path.join(d, "parameters.npz"))
        assert all(np.isfinite(z[key]).all() for key in ("ua_f0", "ut_f0", "mode_amps"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        trun.main([o for o in _ptd_overrides(root, "task.save_dir=prep-card")
                   if o != "proc.cpu=true"])
    _sim, _str, _bow, _ham = tptd.load_data(str(root / "sim" / "0-0"))
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        tptd.build_processed(_sim, _str, _bow, _ham, 0.5, 1.0, SR, 16)


def _batch(rng, n=3, T=100, X=8):
    return [{"u_in": rng.random((T, X)), "f0": rng.random(T), "u0": rng.random(X),
             "kappa": np.array(0.01 * (i + 1))} for i in range(n)]


@pytest.mark.parametrize("t_method", ["sequential", "interpolate", "interleave"])
@pytest.mark.parametrize("x_method", ["interpolate", "pad", "random"])
def test_stack_batch_matches_jax(t_method, x_method):
    """``stack_batch`` (and through it ``set_length``) from the same
    generator state, equal to the JAX function's."""
    batch = _batch(np.random.default_rng(3))
    kw = dict(Nx=16 if x_method != "random" else 6, Nt=50, x_method=x_method,
              t_method=t_method)
    j = jdata.stack_batch(batch, rng=np.random.default_rng(5), **kw)
    t = tdata.stack_batch(batch, rng=np.random.default_rng(5), **kw)
    assert j.keys() == t.keys()
    for key in j:
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert t["u_in"].shape == (3, 50, kw["Nx"]) and t["kappa"].shape == (3,)


def test_data_helpers_match_jax(classic_run):
    """``interpolate``, ``interpolate1d``, ``set_length`` and ``load`` against
    the JAX functions on the same inputs (``load`` on a processed item)."""
    rng = np.random.default_rng(0)
    Nt, Nu = 40, 23
    t = np.arange(Nt)[:, None] / SR
    x = np.linspace(0, 1, Nu)[None, :]
    u = rng.standard_normal((Nt, 4)) @ np.sin(np.pi * np.arange(1, 5)[:, None] * x)
    xv = np.linspace(0, 1, 31)
    np.testing.assert_array_equal(tdata.interpolate(u, t, x, xv),
                                  jdata.interpolate(u, t, x, xv))
    np.testing.assert_array_equal(tdata.interpolate1d(u[:1], x, xv),
                                  jdata.interpolate1d(u[:1], x, xv))
    v = rng.random(10)
    for size, method, idx in ((16, "pad", None), (5, "interpolate", None),
                              (4, "random", np.array([3, 1, 1, 7]))):
        np.testing.assert_array_equal(tdata.set_length(v, size, method, idx),
                                      jdata.set_length(v, size, method, idx))
    with pytest.raises(ValueError):
        tdata.set_length(v, 5, "pad")
    root, items = classic_run
    d = str(root / "prep-load")
    tptd.save_upsampled_data(items[0], d, SR, 16, strict=False, device=CPU)
    for n_sub, how in ((None, "sequential"), (4, "sequential"), (4, "random"), (20, "random")):
        j = jdata.load(d, n_sub, wav_keys=("ut", "ua"), subsample_method=how,
                       rng=np.random.default_rng(2))
        got = tdata.load(d, n_sub, wav_keys=("ut", "ua"), subsample_method=how,
                         rng=np.random.default_rng(2))
        assert j.keys() == got.keys()
        for key in j:
            np.testing.assert_array_equal(got[key], j[key], err_msg=key)
