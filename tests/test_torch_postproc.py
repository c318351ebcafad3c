"""The port's dataset post-processing against the JAX package's.

The same seeded inputs go through both packages in this process: the
batched YIN track and ``postprocess_batch`` (JAX under jit on the CPU, the
port in plain PyTorch on CPU tensors), and the host modules the fused path
uses (spline operators, width spread, modal target, ``build_processed``,
the modal solution and the host YIN), which agree to float64 rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_postproc import _sim_like_state, _tone
from torch_fdtd_string_tpu.core import analytic as janalytic
from torch_fdtd_string_tpu.ops import postproc as jpp
from torch_fdtd_string_tpu.tasks import process_training_data as jptd
from torch_fdtd_string_tpu.utils import data as jdata
from torch_fdtd_string_tpu.utils import frequency as jfreq
from torch_fdtd_string_tpu_torch.core import analytic as tanalytic
from torch_fdtd_string_tpu_torch.ops import postproc as tpp
from torch_fdtd_string_tpu_torch.tasks import process_training_data as tptd
from torch_fdtd_string_tpu_torch.utils import data as tdata
from torch_fdtd_string_tpu_torch.utils import frequency as tfreq

SR = 48000


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("keep", [np.arange(0, 256, 16), np.arange(3, 256, 32)],
                         ids=["stride16", "stride32-offset3"])
def test_spline_operator_stack_identical(keep):
    np.testing.assert_array_equal(tpp.spline_operator_stack(40, keep),
                                  jpp.spline_operator_stack(40, keep))
    np.testing.assert_array_equal(tdata.spline_matrix(37, 256),
                                  jdata.spline_matrix(37, 256))


def test_host_widths_spread_identical():
    for seed in range(3):
        _, f0, kappa, _, k, theta_t, lambda_c = _sim_like_state(seed=seed)
        assert (tpp.host_widths_spread(f0, kappa, k, theta_t, lambda_c)
                == jpp.host_widths_spread(f0, kappa, k, theta_t, lambda_c))


@pytest.mark.parametrize("case", ["clean", "noisy"])
def test_yin_track_matches_jax(case):
    """float32 on both sides, other FFT and reduction orders: the bound of
    test_postproc.py:54-55 (rtol 2e-3, atol 1e-2 on more than 95% of the
    voiced frames), voicing from the host track."""
    noise = 0.0 if case == "clean" else 0.03
    wavs = np.stack([_tone(220.0, noise=noise, seed=1),
                     _tone(130.8, noise=noise, seed=3),
                     _tone(392.0, noise=noise, seed=5)]).astype(np.float32)
    want = np.asarray(jpp.yin_track(jnp.asarray(wavs), SR))
    got = tpp.yin_track(torch.tensor(wavs), SR).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    for b, w in enumerate(wavs):
        voiced = tfreq.track_f0(w, SR)[0] > 0
        agree = np.isclose(got[b], want[b], rtol=2e-3, atol=1e-2)
        assert agree[voiced].mean() > 0.95, (b, got[b][~agree], want[b][~agree])


def test_track_f0_matches_jax():
    for seed, noise in ((0, 0.0), (3, 0.03)):
        w = _tone(196.0, noise=noise, seed=seed)
        f_t, t_t = tfreq.track_f0(w, SR)
        f_j, t_j = jfreq.track_f0(w, SR)
        np.testing.assert_array_equal(t_t, t_j)
        np.testing.assert_allclose(f_t, f_j, rtol=1e-12, atol=1e-12)


def test_postprocess_batch_matches_jax():
    """One seeded (T, B, M) field: ut_keep at f16 quantisation (atol 3e-3),
    vt at rtol 2e-3, umax at rtol 1e-6 (test_postproc.py:105-121), the YIN
    track at test_yin_track_matches_jax's bound."""
    su, f0, kappa, widths, k, theta_t, lambda_c = _sim_like_state(seed=2)
    keep = np.arange(0, 256, 16)
    O = jpp.spline_operator_stack(su.shape[2], keep)
    field = su[:, 2:].transpose(1, 0, 2)
    args = (field, su[:, 1], su[:, 0], f0[:, :2], f0[:, 2:], kappa, O)
    kw = dict(k=k, theta_t=theta_t, lambda_c=lambda_c, sr=SR, G=32)
    want = {key: np.asarray(v) for key, v in
            jpp.postprocess_batch(*(jnp.asarray(a) for a in args), **kw).items()}
    got = {key: v.numpy() for key, v in
           tpp.postprocess_batch(*(torch.tensor(np.ascontiguousarray(a)) for a in args),
                                 **kw).items()}
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    # float32 as postprocess_batch documents it; the JAX track is float64
    # here only because the tests run JAX with x64 enabled
    assert {key: str(v.dtype) for key, v in got.items()} == {
        "ut_keep": "float16", "vt": "float16", "ut_f0": "float32", "umax": "float32"}
    np.testing.assert_allclose(got["ut_keep"].astype(np.float32),
                               want["ut_keep"].astype(np.float32), atol=3e-3)
    vt_j = want["vt"].astype(np.float32)
    np.testing.assert_allclose(got["vt"].astype(np.float32), vt_j, rtol=2e-3,
                               atol=2e-3 * np.abs(vt_j).max())
    np.testing.assert_allclose(got["umax"], want["umax"], rtol=1e-6)
    agree = np.isclose(got["ut_f0"], want["ut_f0"], rtol=2e-3, atol=1e-2)
    assert agree.mean() > 0.95


def test_postprocess_batch_reads_field_in_place():
    """The kernel's (T, B, M) layout is read as a strided view: the result
    equals the one from a contiguous (B, T, M) copy bit for bit, and the
    width groups cover every row (the kept columns match the host
    upsample)."""
    su, f0, kappa, widths, k, theta_t, lambda_c = _sim_like_state(B=2, seed=4)
    keep = np.arange(1, 256, 8)
    O = torch.tensor(tpp.spline_operator_stack(su.shape[2], keep))
    field = torch.tensor(su[:, 2:]).permute(1, 0, 2)  # (T, B, M) view
    kw = dict(k=k, theta_t=theta_t, lambda_c=lambda_c, sr=SR)
    head = (torch.tensor(su[:, 1]), torch.tensor(su[:, 0]),
            torch.tensor(f0[:, :2]), torch.tensor(f0[:, 2:]), torch.tensor(kappa), O)
    a = tpp.postprocess_batch(field, *head, **kw)
    b = tpp.postprocess_batch(field.contiguous(), *head, **kw)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    for i in range(2):
        ref = jdata.upsample_columns(su[i], widths[i], 256)[:, keep]
        np.testing.assert_allclose(a["ut_keep"][i].float().numpy(), ref, atol=3e-3)
    with pytest.raises(ValueError, match="width spread"):
        tpp.postprocess_batch(field, *head, G=1, **kw)


def _string_case(seed):
    rng = np.random.default_rng(seed)
    Nt = 2400
    f0 = 180.0 * (1 + 0.02 * np.sin(np.linspace(0, 2, Nt) + rng.uniform(0, 6)))
    T60 = np.array([[100.0, rng.uniform(10, 25)], [2000.0, rng.uniform(8, 20)]])
    kappa = float(rng.uniform(0.01, 0.03))
    u0 = np.sin(np.pi * np.linspace(0, 1, 256)) * rng.uniform(0.005, 0.02)
    return f0, T60, kappa, u0, Nt


@pytest.mark.parametrize("synth", [True, False], ids=["synth", "modes-only"])
def test_modal_target_host_matches_jax(synth):
    f0, T60, kappa, u0, Nt = _string_case(5)
    keep = np.arange(2, 256, 16)
    want = jpp.modal_target_host(u0, f0, kappa, T60, Nt, SR, keep, synth=synth)
    got = tpp.modal_target_host(u0, f0, kappa, T60, Nt, SR, keep, synth=synth)
    for name, g, w in zip(("ua_keep", "uas", "mode_freq", "mode_amps", "ua_f0"),
                          got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= 1e-9, (name, _rel(g, w))


@pytest.mark.parametrize("table", [True, False], ids=["root-table", "sweep"])
def test_lossy_stiff_string_matches_jax(table, monkeypatch):
    if not table:
        monkeypatch.setenv("FDTD_NO_ROOT_TABLE", "1")
    f0, T60, kappa, u0, Nt = _string_case(6)
    u0_a = u0 @ jdata.spline_matrix(256, 1024, k=5).T
    want = janalytic.lossy_stiff_string(u0_a, f0, kappa, T60, 64, 1024, SR,
                                        strict=False)
    got = tanalytic.lossy_stiff_string(u0_a, f0, kappa, T60, 64, 1024, SR,
                                       strict=False)
    for name, g, w in zip(("u", "mode_freq", "mode_amps"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-9, (name, _rel(g, w))


@pytest.mark.parametrize("x_keep", [None, np.arange(1, 64, 4)], ids=["all", "stride4"])
def test_build_processed_matches_jax(x_keep):
    """The host path of the fused run: one string's native-width state
    through both packages' build_processed (host cosine bank), every array
    at 1e-9 of its scale; then the classic path's device cosine bank."""
    su, f0, kappa, widths, k, theta_t, lambda_c = _sim_like_state(B=1, Nt=1200, seed=7)
    w_nat = int(widths.max())

    def dicts():
        rng = np.random.default_rng(8)
        sim = dict(state_u=su[0, :, :w_nat].copy(), sig0=np.float32(0.5),
                   bow_mask=False, hammer_mask=False, pluck_mask=True)
        st = dict(kappa=kappa[0], alpha=np.float32(3.0), u0=su[0, :1], v0=su[0, :1] * 0,
                  p_a=np.float32(0.01), f0=f0[0], pos=np.float32(0.3),
                  T60=np.array([[100.0, 12.0], [2000.0, 9.0]], np.float32),
                  target_f0=f0[0])
        bow = dict(x_B=rng.random(4), v_B=rng.random(4), F_B=rng.random(4),
                   phi_0=1.0, phi_1=2.0, wid_B=rng.random(4))
        ham = dict(x_H=0.3, v_H=rng.random(4), u_H=rng.random(4), w_H=1.0,
                   M_r=2.0, alpha=3.0)
        return sim, st, bow, ham

    args = (theta_t, lambda_c, SR, 64)
    kw = dict(strict=False, device_synth=False, x_keep=x_keep)
    want = jptd.build_processed(*dicts(), *args, **kw)
    got = tptd.build_processed(*dicts(), *args, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.number) and w.size:
            assert _rel(g, w) <= 1e-9, (key, _rel(g, w))
    # the device bank: the port's on the CPU, JAX's jitted one (float64
    # here, x64 on): the modal target within JAX's own 2e-3 of scale
    # (tests/test_utils.py:264-289), the rest as above
    want = jptd.build_processed(*dicts(), *args, strict=False, x_keep=x_keep)
    got = tptd.build_processed(*dicts(), *args, strict=False, x_keep=x_keep,
                               device=torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key in ("ua", "ua_f0"):
            assert _rel(g, w) <= 2e-3, (key, _rel(g, w))
        elif np.issubdtype(w.dtype, np.number) and w.size:
            assert g.dtype == w.dtype and _rel(g, w) <= 1e-9, (key, _rel(g, w))


def test_data_save_layout(tmp_path):
    """Same files, bytes and npz content as the JAX writer."""
    rng = np.random.default_rng(0)
    item = dict(ut=rng.standard_normal((300, 4)) * 0.1, ua=rng.standard_normal((300, 4)) * 0.1,
                vt=rng.standard_normal(299) * 0.1, x=np.linspace(0, 1, 4)[None],
                gain=2.5, kappa=np.float32(0.02))
    tdata.save(str(tmp_path / "t"), dict(item))
    jdata.save(str(tmp_path / "j"), dict(item))
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in names:
        if name.endswith(".wav"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    zt, zj = np.load(tmp_path / "t" / "parameters.npz"), np.load(tmp_path / "j" / "parameters.npz")
    assert zt.files == zj.files
    for key in zj.files:
        np.testing.assert_array_equal(zt[key], zj[key])
