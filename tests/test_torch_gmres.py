"""The string step's GMRES rescue (``gmres_rescue=True``) in the port.

``string_chunked`` on CPU tensors runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode with ``batch_block=1``, so
that each string leaves its Arnoldi loop on its own, as in the port.  The
CUDA instance is held to the plain version on the card by chip_smoke.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.ops.pallas_step import string_chunked as jax_string_chunked
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload():
    args, _, _, _ = bench.build_workload(B=4, length=0.02, seed=7)
    return args


def _inputs(workload, T, dtype=np.float32):
    carry, _, sp, _, _, _, _, consts = workload
    arrays = [np.array(a, dtype) for a in (sp.f0[:, 2 : 2 + T], sp.kappa, sp.alpha,
                                           sp.pos, sp.T60, carry.u1, carry.u2,
                                           carry.z1, carry.z2)]
    kw = dict(k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
              M_t=consts.M_t, M_l=consts.M_l, surface_integral=True,
              collect_state=True)
    return arrays, kw


def _mix(T, B=4, dtype=np.float32):
    """Bow on strings 0 and 2, hammer on 1, pluck on 3 (the bench draw's
    excitation inputs at the golden fixtures' settings)."""
    bm = np.array([1, 0, 1, 0], bool)
    hm = np.array([0, 1, 0, 0], bool)
    full = lambda v: np.full((B, T), v, dtype)
    bow = dict(x_b=full(0.25), v_b=full(0.2), F_b=full(50.0), wid=full(4.0),
               phi_0=np.full(B, 5.0, dtype), phi_1=np.full(B, 0.1, dtype), mask=bm)
    hammer = dict(x_H=np.full(B, 0.35, dtype), w_H=np.full(B, 2500.0, dtype),
                  M_r=np.full(B, 5.0, dtype), alpha=np.full(B, 3.0, dtype), mask=hm,
                  uH1=np.full(B, -1e-3 + 2.5 / 48000, dtype),
                  uH2=np.full(B, -1e-3, dtype))
    return bow, hammer


@pytest.mark.parametrize("excitation", ["pluck", "mix"])
def test_plain_gmres_matches_jax_kernel(workload, excitation):
    """coupling_iters=1: every step's sweep exits unconverged, so every
    step goes through the rescue; the f32 bounds of
    test_pallas_kernel.py:53-58 over 64 steps (state 1.2e-5 absolute and
    6e-4 of scale, readouts 2e-4)."""
    import jax.numpy as jnp

    T = 64
    arrays, kw = _inputs(workload, T)
    kw.update(coupling_iters=1, gmres_rescue=True)
    exc = {}
    if excitation == "mix":
        bow, hammer = _mix(T)
        exc = dict(bow=bow, hammer=hammer)
    ju, jz, jaux = jax_string_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=T, interpret=True, batch_block=1,
        **{key: {k: jnp.asarray(v) for k, v in d.items()} for key, d in exc.items()}, **kw)
    tu, tz, taux = sk.string_chunked(
        *(torch.tensor(a) for a in arrays),
        **{key: {k: torch.tensor(v) for k, v in d.items()} for key, d in exc.items()}, **kw)
    assert (taux["gmres_iters"] > 0).all()  # the rescue ran at every step
    for g, w in ((tu, ju), (tz, jz)):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - w).max() <= 2e-4 * np.abs(w).max()
    for key, M in (("state_u", kw["M_t"]), ("state_z", kw["M_l"])):
        w = np.asarray(jaux[key])[:, :, :M]
        err = np.abs(taux[key].numpy() - w).max()
        assert err < 1.2e-5 and err < 6e-4 * np.abs(np.asarray(jaux["state_u"])).max(), key


def test_gmres_rescue_exactness(workload):
    """Twin of test_pallas_kernel.py::test_kernel_gmres_rescue_exactness:
    with one sweep per step the rescue alone carries the trajectory, within
    5e-4 of the f64 engine; the same cap without it poisons."""
    import jax.numpy as jnp
    from torch_fdtd_string_tpu.core.engine import simulate_chunk

    carry, steps, sp, bp, hp, bm, hm, consts = workload
    T = 160
    _, o = simulate_chunk(carry, steps[:T], sp, bp, hp, bm, hm,
                          consts._replace(collect_state=True))
    u_eng = np.asarray(o["u"])
    scale = np.abs(u_eng).max()
    arrays, kw = _inputs(workload, T)

    def run(rescue):
        _, _, aux = sk.string_chunked(*(torch.tensor(a) for a in arrays),
                                      coupling_iters=1, gmres_rescue=rescue, **kw)
        return np.abs(aux["state_u"].numpy() - u_eng).max() / scale

    assert run(True) < 5e-4
    assert np.isnan(run(False))


def test_f32_stable_strong_coupling():
    """Twin of test_pallas_kernel.py::test_kernel_f32_stable_strong_coupling:
    alpha=23, f0=392, the default sweep cap with the rescue on; finite and
    within 5e-2 of the f64 engine over 384 steps."""
    from test_golden_reference import _make_cfg, _run_ours

    cfg, _ = _make_cfg(392.0, 0.03, 23.0, "pluck", p_a=0.01, p_x=0.4)
    T = 384
    u_eng = _run_ours(cfg, T + 2)["state_u"][:, 2:, :]
    t = lambda x: torch.tensor(np.asarray(x, np.float32))
    B, M_l = cfg["B"], cfg["M_l"]
    _, _, aux = sk.string_chunked(
        t(cfg["f0"][:, 2 : 2 + T]), t(cfg["kappa"]), t(cfg["alpha"]), t(cfg["pos"]),
        t(cfg["T60"]), t(cfg["u1"]), t(cfg["u2"]), t(np.zeros((B, M_l))),
        t(np.zeros((B, M_l))), k=cfg["k"], theta_t=cfg["theta_t"], lambda_c=1.0,
        M_t=cfg["M_t"], M_l=M_l, surface_integral=False, collect_state=True)
    su = aux["state_u"].numpy().transpose(1, 0, 2)
    assert np.isfinite(su).all()
    assert np.abs(su - u_eng).max() / np.abs(u_eng).max() < 5e-2


def test_rows_only_rerun_equals_whole_batch(workload):
    """The ladder's re-run of a first pass's NaN rows, in place, equals a
    whole-batch GMRES call bit for bit in every field, and leaves the other
    rows as the first pass wrote them."""
    T = 24
    arrays, kw = _inputs(workload, T)
    tensors = [torch.tensor(a) for a in arrays]
    kw.update(coupling_iters=1)
    first = sk.string_chunked_bucketed(*tensors, gmres_rescue=False, **kw)
    fields = lambda out: [out[0], out[1], out[2]["state_u"], out[2]["state_z"],
                          *out[2]["carry"]]
    saved = [x.clone() for x in fields(first)]
    whole = sk.string_chunked_bucketed(*tensors, gmres_rescue=True, **kw)
    rows = [1, 3]
    out = sk.string_chunked_rerun(*tensors, rows=rows, out=first, gmres_rescue=True, **kw)
    assert out[0] is first[0] and out[2]["state_u"] is first[2]["state_u"]  # in place
    for got, want, before in zip(fields(first), fields(whole), saved):
        if got.dim() == 3:  # (T, B, M): rows on axis 1
            got, want, before = (x.transpose(0, 1) for x in (got, want, before))
        assert torch.equal(got[rows], want[rows])
        torch.testing.assert_close(got[[0, 2]], before[[0, 2]], rtol=0, atol=0,
                                   equal_nan=True)
    assert torch.isnan(saved[0][[0, 2]]).any()  # the first pass had poisoned them
    iters = first[2]["gmres_iters"]
    assert (iters[:, rows] > 0).all() and (iters[:, [0, 2]] == 0).all()


def test_plain_rerun_equals_rerun(workload):
    """``string_chunked_rerun_reference`` (the plain re-run the card's
    re-run is held to) writes the rows' whole-batch results in place, as
    ``string_chunked_rerun`` does, counting their Arnoldi iterations."""
    T = 24
    arrays, kw = _inputs(workload, T)
    tensors = [torch.tensor(a) for a in arrays]
    kw.update(coupling_iters=1)
    whole = sk.string_chunked_bucketed(*tensors, gmres_rescue=True, **kw)
    rows = [0, 2]
    outs = []
    for fn in (sk.string_chunked_rerun, sk.string_chunked_rerun_reference):
        first = sk.string_chunked_bucketed(*tensors, gmres_rescue=False, **kw)
        outs.append(fn(*tensors, rows=rows, out=first, gmres_rescue=True, **kw))
        assert outs[-1][0] is first[0]  # in place
    a, b = outs
    for key in ("state_u", "state_z"):  # the other rows: the first pass's NaN
        torch.testing.assert_close(a[2][key], b[2][key], rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.equal(b[2][key][:, rows], whole[2][key][:, rows])
    assert torch.equal(b[0][rows], whole[0][rows])
    assert torch.equal(a[2]["gmres_iters"], b[2]["gmres_iters"])
    assert (b[2]["gmres_iters"][:, rows] > 0).all()
