"""The port's width-bucketed string-step launch against the JAX package's.

``string_chunked_bucketed`` on CPU tensors runs its plain version: the
plain string step per width group, at the group's width, scattered back.
It is held to the port's unbucketed plain version at the bound of
tests/test_pallas_kernel.py:447 (1e-8 absolute: only the order of the
lane reductions may change), and to the JAX ``string_chunked_bucketed`` in
Pallas interpret mode at the f32 bounds of test_torch_string_kernel.py
(the JAX kernel leaves its sweeps per batch block, the port per string).
The CUDA launch itself is held to this plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from test_torch_excitation import _inputs as _exc_inputs
from torch_fdtd_string_tpu.ops import fdm as jfdm
from torch_fdtd_string_tpu.ops import pallas_step as jps
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.run import CONFIG_DIR
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

SR = 48000


def _draw(seed, B, f0_lo, f0_hi, T=64):
    """The inputs of test_pallas_kernel.py::test_bucketed_kernel_matches_plain
    (seed 7, B=32, 90-700 Hz) and ::test_bucketed_kernel_width_clamp_narrow_batch
    (seed 11, B=8, 500-700 Hz), float32 numpy."""
    rng = np.random.default_rng(seed)
    k = 1.0 / SR
    theta = 0.575
    f0c = rng.uniform(f0_lo, f0_hi, B).astype(np.float32)
    f0 = np.repeat(f0c[:, None], T, axis=1)
    kappa = rng.uniform(0.01, 0.06, B).astype(np.float32)
    alpha = rng.uniform(1.0, 8.0, B).astype(np.float32)
    pos = rng.uniform(0.2, 0.8, B).astype(np.float32)
    t60 = np.stack(
        [np.stack([np.full(B, 100.0), rng.uniform(10, 25, B)], 1),
         np.stack([np.full(B, 2000.0), rng.uniform(8, 20, B)], 1)], 1
    ).astype(np.float32)
    var = jfdm.get_derived_vars_np(85.0, 0.0, k, theta, 1.0, 1.0)
    M_t, M_l = var[2] + 1, var[4] + 1
    x = np.linspace(0, 1, M_t, dtype=np.float32)
    u1 = np.broadcast_to(1e-3 * np.sin(np.pi * x), (B, M_t)).copy()
    z1 = np.zeros((B, M_l), np.float32)
    arrays = [f0, kappa, alpha, pos, t60, u1, u1.copy(), z1, z1.copy()]
    kw = dict(k=k, theta_t=theta, lambda_c=1.0, M_t=M_t, M_l=M_l,
              surface_integral=False, gmres_rescue=False, collect_state=True)
    return arrays, kw


def _nsynth_draw(B, seed=1234):
    """The first nsynth-like batch of ``B`` strings, 1 s, from the port's
    sampler: host f0 (B, T), kappa, alpha and the allocation widths."""
    args = tcompose(CONFIG_DIR, ["experiment=nsynth-like", f"task.batch_size={B}"])
    task = args.task
    kw = tsim.task_kwargs(task)
    theta = kw.pop("theta_t")
    string, *_ = tsim.draw_params(
        "pluck", task.sr, theta, task.length, B, task.f0_inf, task.alpha_inf,
        task.lambda_c, rng=np.random.default_rng(seed), **kw)
    T = int(task.length * task.sr)
    return (string.f0[:, 2:T], string.kappa, string.alpha,
            dict(k=1.0 / task.sr, theta_t=theta, lambda_c=task.lambda_c,
                 M_t=string.Nx_t + 1, M_l=string.Nx_l + 1))


def _groups(arrays, kw):
    return sk.bucket_groups(arrays[0], arrays[1], arrays[2], k=kw["k"],
                            theta_t=kw["theta_t"], lambda_c=kw["lambda_c"],
                            M_t=kw["M_t"], M_l=kw["M_l"])


def _port(fn, arrays, kw, bow=None, hammer=None):
    t = lambda d: None if d is None else {key: torch.tensor(v) for key, v in d.items()}
    uout, zout, aux = fn(*(torch.tensor(a) for a in arrays), bow=t(bow),
                         hammer=t(hammer), **kw)
    out = {"uout": uout.numpy(), "zout": zout.numpy()}
    out.update({key: v.numpy() for key, v in aux.items() if key != "carry"})
    out.update({f"carry{j}": x.numpy() for j, x in enumerate(aux["carry"])})
    return out


def _jax(fn, arrays, kw, batch_block, bow=None, hammer=None):
    import jax.numpy as jnp

    j = lambda d: None if d is None else {key: jnp.asarray(v) for key, v in d.items()}
    uout, zout, aux = fn(*(jnp.asarray(a) for a in arrays), bow=j(bow),
                         hammer=j(hammer), chunk=arrays[0].shape[1],
                         batch_block=batch_block, interpret=True, **kw)
    out = {"uout": np.asarray(uout), "zout": np.asarray(zout)}
    out.update({key: np.asarray(v) for key, v in aux.items() if key != "carry"})
    out.update({f"carry{j}": np.asarray(x) for j, x in enumerate(aux["carry"])})
    return out


def _assert_f32_close(got, want):
    """test_torch_string_kernel.py's f32 bounds: state and carry within
    1.2e-5 absolute and 6e-4 of scale, readouts 2e-4 of scale."""
    scale = np.abs(want["state_u"]).max()
    for key in ("state_u", "state_z", "carry0", "carry1", "carry2", "carry3"):
        assert got[key].shape == want[key].shape, key
        err = np.abs(got[key] - want[key]).max()
        assert err < 1.2e-5 and err < 6e-4 * scale, (key, err)
    for key in ("uout", "zout"):
        err = np.abs(got[key] - want[key]).max()
        assert err <= 2e-4 * np.abs(want[key]).max(), (key, err)


def test_grid_bounds_match_jax():
    """Bit for bit on the test draws and the first nsynth-like batches."""
    draws = [(a[0].min(axis=1), a[1], a[2], kw) for a, kw in
             (_draw(7, 32, 90, 700), _draw(11, 8, 500, 700))]
    for B in (24, 48):
        f0, kappa, alpha, kw = _nsynth_draw(B)
        draws.append((np.asarray(f0, np.float32).min(axis=1), kappa, alpha, kw))
    for f0_min, kappa, alpha, kw in draws:
        args = (f0_min, kappa, alpha, kw["k"], kw["theta_t"], kw["lambda_c"])
        for got, want in zip(sk.grid_bounds(*args), jps._grid_bounds(*args)):
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)


def test_bucket_groups_of_nsynth_batches():
    """The B=24 headline batch runs as one clamped group of 128 lanes (its
    strings need 27 to 97); the B=48 corpus batch splits into at least two
    groups, every string in exactly one and within its group's width."""
    f0, kappa, alpha, kw = _nsynth_draw(24)
    assert sk.padded_width(kw["M_t"], kw["M_l"]) == 288
    groups = sk.bucket_groups(f0, kappa, alpha, **kw)
    assert [(w, len(r)) for w, r in groups] == [(128, 24)]

    f0, kappa, alpha, kw = _nsynth_draw(48)
    groups = sk.bucket_groups(f0, kappa, alpha, **kw)
    assert len(groups) >= 2
    assert all(w % 32 == 0 for w, _ in groups)
    # a small group merges upward; the widest has nowhere to merge
    assert all(len(r) >= sk.G_MIN for _, r in groups[:-1])
    assert sorted(np.concatenate([r for _, r in groups]).tolist()) == list(range(48))
    bt, bl = sk.grid_bounds(np.asarray(f0, np.float32).min(axis=1), kappa, alpha,
                            kw["k"], kw["theta_t"], kw["lambda_c"])
    for w, rows in groups:
        assert (np.maximum(bt, bl)[rows] <= w).all()


@pytest.mark.parametrize("case", ["multi-group", "narrow-clamp"])
def test_bucketed_matches_plain(case):
    """Twins of test_pallas_kernel.py::test_bucketed_kernel_matches_plain
    (seed 7, B=32: two or more groups) and
    ::test_bucketed_kernel_width_clamp_narrow_batch (seed 11, B=8: one
    group, narrower than the allocation)."""
    arrays, kw = (_draw(7, 32, 90, 700) if case == "multi-group"
                  else _draw(11, 8, 500, 700))
    groups = _groups(arrays, kw)
    W_alloc = sk.padded_width(kw["M_t"], kw["M_l"])
    if case == "multi-group":
        assert len(groups) >= 2
    else:
        assert len(groups) == 1 and groups[0][0] < W_alloc
    plain = _port(sk.string_chunked, arrays, kw)
    got = _port(sk.string_chunked_bucketed, arrays, kw)
    ref = _port(sk.string_chunked_bucketed_reference, arrays, kw)
    # every string sweeps at least once and at most coupling_iters per step
    assert got["sweeps"].shape == (64, len(arrays[0]))
    assert got["sweeps"].min() >= 1 and got["sweeps"].max() <= 24
    for key, want in plain.items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, rtol=0.0, atol=1e-8, err_msg=key)
        np.testing.assert_array_equal(ref[key], got[key], err_msg=key)
    jax_out = _jax(jps.string_chunked_bucketed, arrays, kw, batch_block=8)
    _assert_f32_close(got, jax_out)


def test_bucketed_mixed_excitation():
    """A bowed, a hammered and a plucked string in one narrow group (128
    lanes against the allocation's 224): the traces, and the bow's force
    profile laid over the allocation's M_t (M_t_sem), equal the unbucketed
    result to 1e-8, and match the JAX bucketed kernel (batch_block=1, as
    tests/test_torch_excitation.py runs it) at the f32 bounds.  Lanes past
    the group's width read 0."""
    arrays, bow, hammer, kw = _exc_inputs("mix", np.float32)
    kw = dict(kw, surface_integral=True)
    (W_g, rows), = _groups(arrays, kw)
    assert W_g < kw["M_t"] < kw["M_l"] and len(rows) == 3
    plain = _port(sk.string_chunked, arrays, kw, bow, hammer)
    got = _port(sk.string_chunked_bucketed, arrays, kw, bow, hammer)
    for key, want in plain.items():
        np.testing.assert_allclose(got[key], want, rtol=0.0, atol=1e-8, err_msg=key)
    assert not got["state_u"][:, :, W_g:].any() and not got["state_z"][:, :, W_g:].any()
    assert not got["carry0"][:, W_g:].any() and not got["carry2"][:, W_g:].any()

    want = _jax(jps.string_chunked_bucketed, arrays, kw, 1, bow, hammer)
    _assert_f32_close(got, want)
    for key, bound in (("v_r", 2e-4), ("u_H", 2e-4), ("F_H", 1e-3)):
        err = np.abs(got[key] - want[key]).max()
        assert err <= bound * max(np.abs(want[key]).max(), 1.0), (key, err)


def test_bucketed_dispatch():
    """CPU tensors take the plain version and do not count as launches; a
    device the port has no path for raises; the bucketed launch sets
    M_t_sem itself."""
    arrays, kw = _draw(11, 8, 500, 700, T=4)
    tensors = [torch.tensor(a) for a in arrays]
    sk.reset_launch_counts()
    sk.string_chunked_bucketed(*tensors, **kw)
    assert sk.string_chunked_bucketed.launches == 0
    assert sk.string_chunked.launches_by_spec == {}
    with pytest.raises(ValueError, match="unsupported device"):
        sk.string_chunked_bucketed(*(t.to("meta") for t in tensors),
                                   host_bounds=(arrays[0], arrays[1], arrays[2]), **kw)
    with pytest.raises(ValueError, match="M_t_sem"):
        sk.string_chunked_bucketed(*tensors, M_t_sem=kw["M_t"], **kw)
    with pytest.raises(TypeError, match="unexpected keyword"):
        sk.string_chunked_bucketed(*tensors, coupling_iter=3, **kw)
