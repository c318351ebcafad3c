"""The port's timing paths against the JAX package's: the time-scaling sweep
(``tasks/time_experiment.py``), its workload and ``pluck_chunked``, and the
sweep-schedule probe (``tools/kernel_timing.py``).

On the CPU the sweep and the probe time the kernel's plain version; the
card's numbers come from chip_smoke.py (phases 15 and 16).
"""

import json

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.ops.pallas_step import pluck_chunked as jax_pluck_chunked
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.tasks import time_experiment as te
from torch_fdtd_string_tpu_torch.tools import kernel_timing as kt


def _strict_json(path):
    """The file's JSON, refusing NaN and infinities."""
    def bad(name):
        raise ValueError(f"non-finite number {name} in {path}")

    with open(path) as f:
        return json.load(f, parse_constant=bad)


@pytest.mark.parametrize("bowed", [False, True], ids=["pluck", "bowed"])
def test_build_workload_draws_equal_bench(bowed):
    """Same generator calls in the same order: every draw of the port's
    workload equals bench.build_workload's bit for bit."""
    want, B, length, want_host = bench.build_workload(B=3, length=0.01, seed=7, bowed=bowed)
    got, B2, length2, got_host = te.build_workload(B=3, length=0.01, seed=7, bowed=bowed)
    assert (B, length) == (B2, length2)
    for w_part, g_part in zip(want[:1] + want[2:7], got[:1] + got[2:7]):
        w_items = w_part._asdict().items() if hasattr(w_part, "_asdict") else [("", w_part)]
        g_items = g_part._asdict().items() if hasattr(g_part, "_asdict") else [("", g_part)]
        for (name, w), (_, g) in zip(w_items, g_items):
            w, g = np.asarray(w), g.numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, name
            np.testing.assert_array_equal(w, g, err_msg=name)
    assert list(np.asarray(want[1])) == list(got[1])
    assert want[7]._asdict() == got[7]._asdict()
    for w, g in zip(want_host, got_host):
        np.testing.assert_array_equal(w, g)


def test_pluck_chunked_matches_jax():
    """The wrapper's return signature and values against the JAX
    ``pluck_chunked`` in interpret mode (its default GMRES rescue on, state
    collected): uout within 2e-4 of scale, the carry and state at the
    bounds of test_pallas_kernel.py:53-58."""
    import jax.numpy as jnp

    T = 128
    workload, _, _, _ = te.build_workload(B=4, length=0.02, seed=7)
    carry, _, sp, _, _, _, _, consts = workload
    arrays = [x.numpy() for x in (sp.f0[:, 2 : 2 + T], sp.kappa, sp.alpha, sp.pos, sp.T60,
                                  carry.u1, carry.u2, carry.z1, carry.z2)]
    kw = dict(k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
              M_t=consts.M_t, M_l=consts.M_l, surface_integral=True, collect_state=True)
    ju, jz, jfin = jax_pluck_chunked(*(jnp.asarray(a) for a in arrays), chunk=T // 2,
                                     interpret=True, batch_block=1, **kw)
    before = dict(sk.string_chunked.launches_by_spec)
    tu, tz, tfin = sk.pluck_chunked(*(torch.from_numpy(a) for a in arrays), **kw)
    assert sk.string_chunked.launches_by_spec == before  # the CPU path does not count
    assert len(tfin) == len(jfin) == 6
    for g, w in ((tu, ju), (tz, jz)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-4 * np.abs(w).max()
    scale = np.abs(np.asarray(jfin[4])).max()
    for g, w in zip(tfin, jfin):
        w = np.asarray(w)[..., : g.shape[-1]]
        err = np.abs(g.numpy() - w).max()
        assert err < 1.2e-5 and err < 6e-4 * scale, err


def test_run_sweep_writes_every_point(tmp_path):
    """The sweep at a tiny size on the CPU: every point of both curves, in
    the JAX layout, finite and positive; the engine only where the JAX
    sweep times it (here at the batch size, not past its own length).  The
    figure is tests/test_torch_plot.py's (a log axis over one point takes
    matplotlib half a minute)."""
    res = te.run_sweep(str(tmp_path), batches=(2,), lengths=(0.011,), device="cpu",
                       batch_length=0.011, engine_length=0.002, reps=1, plot=False)
    data = _strict_json(tmp_path / "time_experiment.json")
    assert data == json.loads(json.dumps(res))
    assert data["backend"] == "cpu" and sorted(data) == ["backend", "batch", "device",
                                                         "length"]
    want = {"batch": {"kernel": [2], "engine": [2]},
            "length": {"kernel": [0.011], "engine": []}}
    for axis, curves in want.items():
        assert sorted(data[axis]) == ["engine", "kernel"]
        for curve, xs in curves.items():
            assert [x for x, _ in data[axis][curve]] == xs
            assert all(t > 0 for _, t in data[axis][curve])


def test_failing_point_raises(tmp_path, monkeypatch):
    """A point that fails stops the sweep: no curve is written with it
    missing (the JAX sweep's ``_try`` prints and goes on)."""
    def broken(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(te, "_time_kernel", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        te.run_sweep(str(tmp_path), batches=(2,), lengths=(0.011,), device="cpu",
                     batch_length=0.011, with_engine=False, reps=1)
    assert not (tmp_path / "time_experiment.json").exists()


def test_sweep_and_probe_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.run_sweep("unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kt.run_timing()


def test_kernel_timing_reports_every_variant():
    """The probe at a tiny size on the CPU: each variant's wall and rate,
    each fixed variant's deviation from the adaptive exit, one JSON line
    with no NaN."""
    res = kt.run_timing(reps=1, device="cpu", sizes=((2, 0.011),))
    assert sorted(res) == ["b2_adaptive", "b2_fixed1", "b2_fixed2"]
    for name, row in res.items():
        assert row["wall_s"] > 0 and row["audio_s_per_s"] > 0
        if name != "b2_adaptive":
            assert 0 <= row["max_rel_dev_vs_adaptive"] < 5e-2
            assert row["nonfinite_strings"] == 0
    # two plain sweeps reach the adaptive fixed point closer than one
    assert res["b2_fixed2"]["max_rel_dev_vs_adaptive"] < res["b2_fixed1"]["max_rel_dev_vs_adaptive"]
    assert json.loads(json.dumps(res, allow_nan=False)) == res
