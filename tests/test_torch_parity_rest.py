"""The last JAX functions the port lacked, against the JAX package's.

``utils/frequency.py``'s frame-loop YIN (``yin_frame_f0``,
``track_f0_loop``) and the vectorised tracker held to it as
``tests/test_postproc.py`` holds the JAX one; ``ops/tridiag.py``'s
Toeplitz helpers in float64, and the PCR solve of their coefficients
against a dense solve as in ``tests/test_tridiag.py``; ``ops/ddsp.py``'s
``safe_log``; ``ops/string_kernel.py``'s ``PluckKernelConsts``;
``tasks/trainer.py::dryrun_train_step`` on the CPU; ``utils/profiling.py``'s
``device_timer`` and ``trace`` on the CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.ops import ddsp as jddsp
from torch_fdtd_string_tpu.ops import tridiag as jtri
from torch_fdtd_string_tpu.utils import frequency as jfreq
from torch_fdtd_string_tpu.utils import profiling as jprof
from torch_fdtd_string_tpu_torch.ops import ddsp as tddsp
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.ops import tridiag as ttri
from torch_fdtd_string_tpu_torch.tasks import trainer as ttrainer
from torch_fdtd_string_tpu_torch.utils import frequency as tfreq
from torch_fdtd_string_tpu_torch.utils import profiling as tprof

SR = 48000


def _tone(f0, Nt=24000, decay=3.0, noise=0.0, seed=0):
    """A decaying tone with a slightly sharp second partial (the
    ``tests/test_postproc.py`` tones)."""
    rng = np.random.default_rng(seed)
    t = np.arange(Nt) / SR
    w = np.sin(2 * np.pi * f0 * t) * np.exp(-decay * t)
    w += 0.3 * np.sin(2 * np.pi * 2.01 * f0 * t) * np.exp(-decay * 1.5 * t)
    if noise:
        w += noise * rng.standard_normal(Nt)
    return w


@pytest.mark.parametrize("f0,noise,seed", [(220.0, 0.0, 0), (130.8, 0.03, 3)],
                         ids=["clean", "noisy"])
def test_frame_loop_yin_matches_jax(f0, noise, seed):
    w = _tone(f0, noise=noise, seed=seed)
    got, t_got = tfreq.track_f0_loop(w, SR)
    want, t_want = jfreq.track_f0_loop(w, SR)
    np.testing.assert_array_equal(t_got, t_want)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    frame = w[4800:4800 + 3072]
    assert abs(tfreq.yin_frame_f0(frame, SR) - jfreq.yin_frame_f0(frame, SR)) <= (
        1e-12 * jfreq.yin_frame_f0(frame, SR))
    # the vectorised tracker against its loop twin (tests/test_postproc.py:31-38)
    vec, t_vec = tfreq.track_f0(w, SR)
    np.testing.assert_allclose(t_vec, t_got)
    np.testing.assert_allclose(vec, got, rtol=1e-9, atol=1e-9)


def test_frame_loop_yin_of_silence():
    assert tfreq.yin_frame_f0(np.zeros(3072), SR) == jfreq.yin_frame_f0(np.zeros(3072), SR)
    f0, _ = tfreq.track_f0_loop(np.zeros(SR // 4), SR)
    assert np.all(f0 == 0.0)


def _toeplitz_case(seed=3, B=3, M=48):
    rng = np.random.default_rng(seed)
    a = np.array([0.2, -0.15, 0.0])
    c = np.array([0.2, -0.15, 0.0])  # symmetric: the closed form is exact
    b = np.array([1.4, 1.1, 2.0])
    n = np.array([48.0, 31.0, 7.0])
    rhs = rng.normal(size=(B, M)) * (np.arange(M)[None] < n[:, None])
    return a, b, c, n, rhs


def test_dst_toeplitz_solve_matches_jax():
    a, b, c, n, rhs = _toeplitz_case()
    want = np.asarray(jtri.dst_toeplitz_solve(*(jnp.asarray(x) for x in (a, b, c, n, rhs))))
    got = ttri.dst_toeplitz_solve(*(torch.as_tensor(x) for x in (a, b, c, n, rhs)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    # and the dense solve (tests/test_tridiag.py::test_dst_toeplitz_solve_matches_dense)
    for i, m in enumerate(n.astype(int)):
        T = (np.diag(np.full(m, b[i])) + np.diag(np.full(m - 1, a[i]), -1)
             + np.diag(np.full(m - 1, c[i]), 1))
        np.testing.assert_allclose(got[i, :m].numpy(), np.linalg.solve(T, rhs[i, :m]),
                                   atol=1e-10)
        assert not got[i, m:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_toeplitz_coeffs_match_jax_and_solve(dtype):
    B, M = 3, 64
    a, b, n = np.array([0.2, -0.1, 0.05]), np.array([1.5, 2.0, 1.1]), np.array([64.0, 40.0, 5.0])
    want = jtri.toeplitz_tridiag_coeffs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(n), M)
    got = ttri.toeplitz_tridiag_coeffs(torch.as_tensor(a), torch.as_tensor(b),
                                       torch.as_tensor(n), M, dtype=dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, M)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    # the PCR solve of the coefficients against the dense Toeplitz solve
    # (tests/test_tridiag.py::test_toeplitz_coeffs_and_solve)
    rng = np.random.default_rng(1)
    rhs = rng.normal(size=(B, M)) * (np.arange(M)[None] < n[:, None])
    x = ttri.tridiag_solve(*got, torch.as_tensor(rhs, dtype=dtype)).numpy()
    for i, m in enumerate(n.astype(int)):
        T = (np.diag(np.full(m, b[i])) + np.diag(np.full(m - 1, a[i]), 1)
             + np.diag(np.full(m - 1, a[i]), -1))
        np.testing.assert_allclose(x[i, :m], np.linalg.solve(T, rhs[i, :m]),
                                   atol=1e-10 if dtype == torch.float64 else 1e-5)


def test_safe_log_and_the_kernel_consts_alias():
    x = np.array([0.0, 1e-9, 0.5, 3.0])
    np.testing.assert_allclose(tddsp.safe_log(torch.as_tensor(x)).numpy(),
                               np.asarray(jddsp.safe_log(jnp.asarray(x))), rtol=1e-15)
    assert sk.PluckKernelConsts is sk.KernelConsts


def test_dryrun_train_step_on_the_cpu():
    """One step of the tiny physics-estimator synthesizer: finite losses
    under the keys of the JAX ``dryrun_train_step``'s loss dict (its
    criteria ``l1`` and ``modeamps``, and ``loss``)."""
    losses = ttrainer.dryrun_train_step(batch_size=4, device="cpu")
    assert sorted(losses) == ["l1", "loss", "modeamps"]
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["loss"] == pytest.approx(losses["l1"] + losses["modeamps"], rel=1e-6)


def test_dryrun_train_step_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.dryrun_train_step()


def test_device_timer_logs_as_jax(tmp_path):
    log_t, log_j = {}, {}
    for timer, log in ((tprof.device_timer, log_t), (jprof.device_timer, log_j)):
        with timer("step", log):
            sum(range(1000))
        with timer("step", log, sync=False):
            pass
    assert sorted(log_t) == sorted(log_j) == ["step"]
    assert len(log_t["step"]) == len(log_j["step"]) == 2
    assert all(isinstance(v, float) and v >= 0.0 for v in log_t["step"])
    with tprof.device_timer("no log"):  # without a log it only times
        pass


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    path = tmp_path / "trace" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    assert any("cumsum" in evt.key for evt in prof.key_averages())
    assert os.path.getsize(path) > 0
