"""The port's DMSP losses, metrics and test scores against the JAX
package's, on the same seeded numpy inputs.

Losses and metrics run in float32 on both sides (the JAX package with x64
enabled, tests/conftest.py); the per-item test scores run in float64 on
the host in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmsp_modules import SR, rel_err
from torch_fdtd_string_tpu.models import losses as jlosses
from torch_fdtd_string_tpu.models import objective as jobj
from torch_fdtd_string_tpu.tasks import synthesize as jsynth
from torch_fdtd_string_tpu_torch.models import losses as tlosses
from torch_fdtd_string_tpu_torch.models import objective as tobj
from torch_fdtd_string_tpu_torch.tasks import synthesize as tsynth

B, NT, NF, NM = 4, 2400, 11, 8


def outputs(seed=0, dtype=np.float32):
    """A prediction dict with every key the registries read."""
    rng = np.random.default_rng(seed)
    t = np.arange(NT) / SR
    f0 = rng.uniform(150, 400, (B, 1))
    target = (np.sin(2 * np.pi * f0 * t) * np.exp(-3 * t) * rng.uniform(0.1, 1, (B, 1))
              + 0.01 * rng.standard_normal((B, NT)))
    preds = target + 0.05 * rng.standard_normal((B, NT))
    omega = 2 * np.pi * f0 / SR * (1 + 0.01 * np.linspace(0, 1, NF))
    fk = np.cumsum(rng.uniform(0.01, 0.05, (B, 1, NM)), -1)
    ck = rng.uniform(-0.01, 0.01, (B, 1, NM))
    field = np.cumsum(0.01 * rng.standard_normal((B, 40, 16)), 1)
    out = dict(
        preds=preds, target=target,
        preds_f0=omega * (1 + 0.003 * rng.standard_normal((B, NF))), target_f0=omega,
        preds_fk=fk * (1 + 0.01 * rng.standard_normal(fk.shape)), target_fk=fk,
        preds_freq=fk * (1 + 0.02 * rng.standard_normal(fk.shape)),
        preds_coef=ck + 0.001 * rng.standard_normal(ck.shape), target_ck=ck,
        preds_bc=field[..., [0, -1]], preds_ic=field[:, 0], target_ic=field[:, 0] + 0.001,
    )
    return {k: v.astype(dtype) for k, v in out.items()}


# relative difference per loss, measured on the CPU (the float32 FFTs and
# reductions of XLA against torch's): f0 3.8e-7, ic 3.5e-7, melspec
# 2.5e-7, sisdr 1.2e-7, l1 9.6e-8, mse 9.5e-8, fft 8.8e-8, the others 0.
# Bounds 10x, at least 1e-6
LOSS_BOUNDS = {"l1": 1e-6, "mse": 1e-6, "f0": 4e-6, "fk": 1e-6, "sisdr": 2e-6,
               "fft": 1e-6, "magspec": 1e-6, "melspec": 3e-6, "mrstft": 1e-6,
               "modefreq": 1e-6, "modeamps": 1e-6, "bc": 1e-6, "ic": 4e-6}


@pytest.mark.parametrize("name", sorted(LOSS_BOUNDS))
def test_loss_matches_jax(name):
    jreg, treg = jlosses.build_loss_registry(SR, NT), tlosses.build_loss_registry(SR, NT)
    assert sorted(jreg) == sorted(treg) == sorted(LOSS_BOUNDS)
    (jf, jkeys), (tf, tkeys) = jreg[name], treg[name]
    assert jkeys == tkeys
    out = outputs()
    want = float(jf(*[jnp.asarray(out[k]) for k in jkeys]))
    got = tf(*[torch.as_tensor(out[k]) for k in tkeys])
    assert got.dtype == torch.float32 and got.dim() == 0
    assert rel_err(want, got) <= LOSS_BOUNDS[name], (name, rel_err(want, got))


def test_compute_losses_sums_the_criteria():
    out = outputs(1)
    criteria = ["l1", "magspec", "melspec", "f0", "modefreq", "modeamps"]
    jt, jd = jsynth.compute_losses({k: jnp.asarray(v) for k, v in out.items()},
                                   jlosses.build_loss_registry(SR, NT), criteria)
    tt, td = tsynth.compute_losses({k: torch.as_tensor(v) for k, v in out.items()},
                                   tlosses.build_loss_registry(SR, NT), criteria)
    assert sorted(jd) == sorted(td) == sorted(criteria + ["loss"])
    assert rel_err(float(jt), tt) < 1e-6
    assert float(td["loss"]) == pytest.approx(sum(float(td[c]) for c in criteria), rel=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_fft", [1024, 256])
def test_stft_mag_matches_jax(n_fft, dtype):
    """Reflect padding by n_fft//2, periodic Hann, rfft: float32 within 1e-6
    and float64 within 1e-12 of the JAX package's scale."""
    x = np.random.default_rng(2).standard_normal((3, 2, NT)).astype(dtype)
    want = jlosses.stft_mag(jnp.asarray(x), n_fft, n_fft // 4)
    got = tlosses.stft_mag(torch.as_tensor(x), n_fft, n_fft // 4)
    assert got.shape == want.shape
    assert rel_err(want, got) < (1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("scaling", [True, False])
def test_si_sdr_matches_jax(scaling):
    out = outputs(3, np.float64)
    want = jlosses.si_sdr(jnp.asarray(out["target"]), jnp.asarray(out["preds"]), scaling=scaling)
    got = tlosses.si_sdr(torch.as_tensor(out["target"]), torch.as_tensor(out["preds"]),
                         scaling=scaling)
    assert rel_err(want, got) < 1e-12


def test_pde_loss_matches_jax():
    """The PDE scaffolding on a smooth space-time field, float64: each of
    the three terms and their weighted sum."""
    rng = np.random.default_rng(4)
    Nt, Nx = 40, 24
    x = np.linspace(0, 1, Nx)
    t = np.arange(Nt) / SR
    ut = (np.sin(np.pi * x)[None, None] * np.cos(2 * np.pi * 300 * t)[None, :, None]
          * rng.uniform(0.5, 1, (2, 1, 1)))
    args = (ut[:, 0], x, t, np.array([150.0, 200.0]), np.array([0.02, 0.01]),
            np.array([0.5, 0.7]), np.array([1e-5, 2e-5]))
    want = jlosses.pde_loss(jnp.asarray(ut), *(jnp.asarray(a) for a in args), w_r=1e-9)
    got = tlosses.pde_loss(torch.as_tensor(ut), *(torch.as_tensor(a) for a in args), w_r=1e-9)
    assert rel_err(want, got) < 1e-12
    r_j = jlosses.fdtd_residual(jnp.asarray(ut), *(jnp.asarray(a) for a in args[1:]))
    r_t = tlosses.fdtd_residual(torch.as_tensor(ut), *(torch.as_tensor(a) for a in args[1:]))
    assert rel_err(r_j, r_t) < 1e-12
    assert rel_err(jlosses.dirichlet_bc(jnp.asarray(ut)),
                   tlosses.dirichlet_bc(torch.as_tensor(ut))) < 1e-12


@pytest.mark.parametrize("name", ["mrstft", "sisdr", "modefreq", "modeamps", "mse", "l1",
                                  "pde"])
def test_metric_matches_jax(name):
    """Two batches accumulated, then a third metric merged in: the running
    (sum, count) state and the mean, within 1e-6 (float32 inputs)."""
    jreg, treg = jobj.build_metric_registry(SR), tobj.build_metric_registry(SR)
    assert sorted(jreg) == sorted(treg)
    (jm, jkeys), (tm, tkeys) = jreg[name], treg[name]
    assert jkeys == tkeys
    (jm2, _), (tm2, _) = jobj.build_metric_registry(SR)[name], tobj.build_metric_registry(SR)[name]
    for seed, (j, t) in ((5, (jm, tm)), (6, (jm, tm)), (7, (jm2, tm2))):
        out = outputs(seed)
        rng = np.random.default_rng(seed)
        out.update(pde_preds=np.cumsum(0.01 * rng.standard_normal((B, 40, 16, 1)), 1),
                   u_0=rng.standard_normal((B, 16)), xg=np.linspace(0, 1, 16),
                   tg=np.arange(40) / SR, f_0=rng.uniform(150, 300, B),
                   ka=rng.uniform(0.01, 0.03, B), sig0=rng.uniform(0.1, 1, B),
                   sig1=rng.uniform(1e-6, 1e-5, B))
        j.update(*[out[k] for k in jkeys])
        t.update(*[out[k] for k in tkeys])
    jm.merge(jm2)
    tm.merge(tm2)
    assert tm.count == jm.count > 0
    assert rel_err(jm.total, tm.total) < 1e-6 and rel_err(jm.compute(), tm.compute()) < 1e-6
    tm.reset()
    assert (tm.total, tm.count, tm.compute()) == (0.0, 0, 0.0)


def _prep(seed=8):
    rng = np.random.default_rng(seed)
    out = outputs(seed, np.float64)
    u0 = np.abs(rng.standard_normal((B, 1, 32)))
    u0[0, 0, 5] = u0[0, 0, 9] = u0[0, 0].max() + 1  # a tie: the first index
    return out, dict(u_0=u0.astype(np.float32),
                     xg=rng.uniform(0, 1, (B, 1)).astype(np.float32),
                     ka=rng.uniform(0.01, 0.03, (B, 1)).astype(np.float32),
                     al=rng.uniform(1, 20, (B, 1)).astype(np.float32))


def test_summarize_eval_scores_matches_jax():
    """Every column of the score row, float64 on the host: 1e-9 of each
    column's scale (the f0 detune's inputs are float32 on both sides)."""
    out, prep = _prep()
    args = (out["preds"], out["target"], out["preds_f0"].astype(np.float32),
            out["target_f0"].astype(np.float32), SR)
    want = jsynth.summarize_eval_scores(prep, *args)
    got = tsynth.summarize_eval_scores(prep, *args)
    assert list(got) == list(want)
    for key in want:
        assert np.asarray(got[key]).shape == (B,)
        assert rel_err(want[key], got[key]) < 1e-9, key
    assert got["p_x"][0] == 5 / 31


def test_item_scores_matches_jax():
    out, _ = _prep(9)
    f0_hz = np.full((B, NF + 2), 220.0)
    want = jsynth.item_scores(out["preds"], out["target"], SR, f0_hz, out["preds_f0"])
    got = tsynth.item_scores(out["preds"], out["target"], SR, f0_hz, out["preds_f0"])
    assert list(got) == list(want) == ["si_sdr", "sdr", "logmag", "f0_hz"]
    for key in want:
        assert rel_err(want[key], got[key]) < 1e-9, key


def test_prepare_batch_matches_jax():
    """The numpy batch preparation is the JAX package's, array for array."""
    rng = np.random.default_rng(10)
    Nt, Nx = 1000, 16
    batch = dict(
        target=rng.standard_normal((B, Nt)), x=rng.uniform(0, 1, (B,)),
        t=np.tile(np.arange(Nt)[:, None] / SR, (B, 1, 1)), kappa=rng.uniform(0.01, 0.03, (B,)),
        alpha=rng.uniform(1, 20, (B,)), mode_freq=rng.uniform(0, 0.5, (B, 12)),
        mode_coef=rng.uniform(-1, 1, (B, 1, 1, 12)), f0=rng.uniform(100, 400, (B, Nt)),
        u0=rng.uniform(0, 0.01, (B, 1, Nx)), T60=rng.uniform(1, 20, (B, 2, 2)),
        ut_f0=rng.uniform(100, 400, (B, 90)), ua_f0=rng.uniform(100, 400, (B, 90)),
        gain=rng.uniform(1, 2, (B,)), analytic=rng.standard_normal((B, Nt)),
    )
    want = jsynth.prepare_batch(batch, 8, 64, SR)
    got = tsynth.prepare_batch(batch, 8, 64, SR)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    dev = tsynth.to_device(got, torch.device("cpu"))
    assert all(torch.equal(dev[k], torch.as_tensor(got[k])) for k in got)
