"""The port's NaN rescue ladder (``tasks/simulate.py``), twins of
tests/test_rescue.py.

The f64 rescue is held to the JAX package's ``rescue_nan_elements`` on
the draws of tests/test_rescue.py.  Whole CPU runs (classic and fused) are
drawn at a strongly coupled corner (alpha 24.5-25, f0 300-320 Hz, kappa
0.010-0.012) where the first pass, the string kernel's plain version in
float32, poisons one string within 5 ms.  (The JAX test's corner, alpha~23
and f0~415, stays finite in the port's first pass: its sweeps back off per
string and run up to 24 times, where the JAX engine's stop at 8.)  They are
held to the ladder's counters and to the JAX rescue of the same string.
That string's motion is chaotic: the two f64 engines, the same algorithm in
different rounding, part by ten times every ~16 steps (1e-12 at step 40,
1e-9 at 100, 1e-1 at 220, on a CPU), so the spliced rows are held to the
JAX rescue over the first 96 steps.
"""

import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.core.engine import SimConsts as JaxSimConsts
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.core import engine as teng
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils.config import compose

LENGTH = 0.005
CORNER = (("f0_min", 300.0), ("f0_max", 320.0), ("f0_diff_max", 0.0),
          ("f0_mod_max", 0.0), ("kappa_min", 0.010), ("kappa_max", 0.012),
          ("alpha_min", 24.5), ("alpha_max", 25.0))


def _args(fuse):
    args = compose(trun.CONFIG_DIR, [
        "experiment=nsynth-like", "task.num_samples=4", "task.batch_size=4",
        f"task.length={LENGTH}", f"task.chunk_length={LENGTH}",
        "task.randomize_name=false", "proc.cpu=true", "task.rescue_nan=true",
        f"task.fuse_preprocess={'true' if fuse else 'false'}"])
    sc = args.task.string_condition
    for key, val in CORNER:
        for d in sc:
            if key in d:
                d[key] = val
                break
        else:
            sc.append({key: val})
    return args


def test_rescue_matches_jax():
    """rescue_nan_elements against the JAX package's on the same draws and
    row (test_rescue.py's): every output within 1e-9 of its own scale."""
    from torch_fdtd_string_tpu_torch.ops import fdm

    sr, length, B = 48000, 0.005, 3
    theta = fdm.get_theta(0.03, 150.0, sr)
    string, bow, hammer, bm, hm, _ = tsim.draw_params(
        "pluck", sr, theta, length, B, 150.0, 1.0, 1.0,
        string_kwargs=dict(f0_min=150.0, f0_max=200.0, f0_mod_max=0.0,
                           f0_diff_max=0.0, kappa_min=0.01, kappa_max=0.03,
                           alpha_min=1.0, alpha_max=3.0),
        rng=np.random.default_rng(3))
    consts = tsim.sim_consts(string, bm, hm, sr, theta, 1.0)
    idx, Nt = np.array([1]), int(length * sr)
    want = jsim.rescue_nan_elements(string, bow, hammer, bm, hm, idx,
                                    JaxSimConsts(*consts), Nt, Nt, sr)
    got = tsim.rescue_nan_elements(string, bow, hammer, bm, hm, idx, consts, Nt, Nt, sr)
    names = ("uout", "zout", "state_u", "state_z", "v_r", "F_H", "u_H", "sig0", "sig1")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == np.float64 and g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), name


@pytest.fixture(scope="module")
def corner():
    """The run's draws, its first pass's NaN rows, and the JAX package's
    f64 rescue of them."""
    args = _args(False)
    task = args.task
    kw = tsim.task_kwargs(task)
    theta = kw.pop("theta_t")
    draws = tsim.draw_params(
        "pluck", task.sr, theta, task.length, task.batch_size, task.f0_inf,
        task.alpha_inf, task.lambda_c, precision=task.precision,
        randomize_each=task.randomize_each, rng=np.random.default_rng(args.proc.seed),
        **kw)
    string, bow, hammer, bm, hm, _ = draws
    consts = tsim.sim_consts(string, bm, hm, task.sr, theta, task.lambda_c,
                             relative_order=task.relative_order,
                             surface_integral=task.surface_integral)
    Nt = int(task.length * task.sr)
    uout = tsim.process(string, bow, hammer, bm, hm, consts, Nt,
                        torch.device("cpu"), sr=task.sr)[0]
    idx = np.nonzero(np.isnan(uout.sum(-1)))[0]
    assert len(idx) == 1, idx
    want = jsim.rescue_nan_elements(string, bow, hammer, bm, hm, idx,
                                    JaxSimConsts(*consts), Nt, Nt, task.sr)
    return SimpleNamespace(draws=draws, consts=consts, Nt=Nt, idx=idx, want=want,
                           sr=task.sr)


@pytest.mark.parametrize("fuse", [False, True], ids=["classic", "fused"])
def test_run_level_rescue(corner, tmp_path, fuse):
    """Twin of test_rescue.py::test_run_level_rescue_splices_or_skips on the
    CPU: the first pass's NaN string is rescued in f64 and spliced in; the
    counters add up; nothing on disk is NaN; the spliced readout and state
    are the JAX rescue's over the first 96 steps (to the float32 the run
    stores; the module docstring says why not beyond)."""
    out = str(tmp_path / "run")
    tsim.run(_args(fuse), out, "pluck", 1)
    with open(os.path.join(out, "skip_stats.json")) as f:
        stats = json.load(f)
    batches = stats["batches"] if fuse else stats
    (b,) = batches
    assert b["nan_first_pass"] == 1 and b["rescued_f64"] == 1
    assert b["rescued_kernel_gmres"] == 0  # stage 1 runs on the card only
    assert b["nan_first_pass"] == b["rescued_kernel_gmres"] + b["rescued_f64"] + b["nan_final"]
    assert b["rescue_f64_rows"] == corner.idx.tolist()
    (r,) = corner.idx
    want_u = np.asarray(corner.want[0][0])
    if fuse:
        assert stats["save_timing"]["host_build"]["n"] == 1  # the spliced item
        items = sorted(glob.glob(out + "-prep/*/parameters.npz"))
        assert len(items) == 4
        for path in items:
            z = np.load(path)
            assert all(np.isfinite(z[k]).all() for k in z.files if z[k].dtype.kind == "f")
        got_u = np.load(f"{out}-prep/0-{r}/parameters.npz")["uout"]
    else:
        for d in sorted(glob.glob(out + "/0-*")):
            z = np.load(os.path.join(d, "simulation.npz"))
            for key in ("uout", "zout", "state_u", "state_z", "v_r_out", "u_H_out"):
                assert np.isfinite(z[key]).all(), (d, key)
        z = np.load(f"{out}/0-{r}/simulation.npz")
        got_u = z["uout"]
        want_su = np.asarray(corner.want[2][0])
        np.testing.assert_allclose(z["state_u"][:96], want_su[:96, : z["state_u"].shape[1]],
                                   rtol=0, atol=1e-6 * np.abs(want_su).max())
        assert np.isfinite(want_su).all()
    np.testing.assert_allclose(got_u[:96], want_u[:96], rtol=0,
                               atol=1e-6 * np.abs(want_u).max())


def test_batched_gmres_rescue_isolated():
    """Twin of test_rescue.py::test_batched_gmres_rescue_isolated: in one
    batched f64 GMRES run a NaN string leaves its neighbours within 1e-6 of
    their single-string runs."""
    args, B, _, _ = bench.build_workload(B=4, length=0.01, seed=3)
    carry, steps, sp, bp, hp, bm, hm, consts = args
    t = lambda tree, cls: cls(*(torch.tensor(np.asarray(v, np.float64)) for v in tree))
    carry, sp, bp, hp = (t(carry, teng.Carry), t(sp, teng.StringParams),
                         t(bp, teng.BowParams), t(hp, teng.HammerParams))
    bm, hm = torch.tensor(np.asarray(bm)), torch.tensor(np.asarray(hm))
    c = teng.SimConsts(*consts._replace(coupling_solver="gmres", coupling_max_iter=64,
                                        collect_state=False))
    T = 48
    steps = np.asarray(steps[:T])
    u1_bad = carry.u1.clone()
    u1_bad[2, 3] = float("nan")
    _, out = teng.simulate_chunk(carry._replace(u1=u1_bad), steps, sp, bp, hp, bm, hm, c)
    uout = out["uout"].numpy().T
    assert np.isnan(uout[2]).any() and np.isfinite(uout[[0, 1, 3]]).all()
    one = lambda tree, j: type(tree)(*(v[j : j + 1] for v in tree))
    for j in (0, 1, 3):
        _, o1 = teng.simulate_chunk(one(carry, j), steps, one(sp, j), one(bp, j),
                                    one(hp, j), bm[j : j + 1], hm[j : j + 1], c)
        u1j = o1["uout"].numpy()[:, 0]
        assert np.abs(uout[j] - u1j).max() / np.abs(u1j).max() < 1e-6, j


def test_kernel_gmres_rerun_policy():
    """Twin of test_rescue.py::test_nan_skip_policy_disables_whole_ladder:
    nsynth-like (rescue_nan=false) takes no re-run, the default task does;
    CPU and double-precision runs never do."""
    card = SimpleNamespace(proc=SimpleNamespace(cpu=False))
    gen = compose(trun.CONFIG_DIR, ["experiment=nsynth-like"])
    assert gen.task.rescue_nan is False
    assert not tsim.kernel_gmres_rerun_enabled(gen.task, card)
    ver = compose(trun.CONFIG_DIR, [])
    assert ver.task.get("rescue_nan", True)
    assert tsim.kernel_gmres_rerun_enabled(ver.task, card)
    assert not tsim.kernel_gmres_rerun_enabled(
        ver.task, SimpleNamespace(proc=SimpleNamespace(cpu=True)))
    dbl = compose(trun.CONFIG_DIR, ["task.precision=double"])
    assert not tsim.kernel_gmres_rerun_enabled(dbl.task, card)
