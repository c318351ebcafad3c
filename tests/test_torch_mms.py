"""The string step's manufactured-solution (MMS) forcing in the port.

``string_chunked`` on CPU tensors runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode with ``batch_block=1``, as
tests/test_pallas_kernel.py's MMS test does.  The forcing turns the string
step into a verification of the scheme: the state must track the closed
form ``p_a cos^2(pi x) cos(gamma t) exp(-sig0 t)`` and converge at second
order with ``mms_centered``.  The CUDA kernel is held to the plain version
on the card by chip_smoke.py (phase 3 (s)).
"""

import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu.ops.pallas_step import string_chunked as jax_string_chunked
from torch_fdtd_string_tpu_torch.core.analytic import manufactured_solution
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.ops.fdm import get_derived_vars_np, get_theta
from torch_fdtd_string_tpu_torch.utils.audio import T60_to_sigma

T60S = [[1000.0, 20.0], [100.0, 20.0]]


def mms_inputs(f0s, sr, T, p_as, kappa=0.03, dtype=np.float64):
    """The JAX MMS twin's inputs (test_pallas_kernel.py::_kernel_mms) for
    strings of fundamentals ``f0s`` and amplitudes ``p_as``: the allocation
    of the lowest f0, each string's initial rows ``p_a cos^2(pi x)`` on its
    own live grid.  Returns ``(arrays, kw, N_t)``, ``N_t`` per string."""
    f0s, p_as = np.asarray(f0s, np.float64), np.asarray(p_as, np.float64)
    B = len(f0s)
    k = 1.0 / sr
    theta = get_theta(kappa, float(f0s.min()), sr)
    _, _, nx_t, _, nx_l, _ = get_derived_vars_np(float(f0s.min()), 0.0, k, theta, 1.0, 1.0)
    M_t, M_l = int(nx_t) + 1, int(nx_l) + 1
    N_t = np.array([int(get_derived_vars_np(f, kappa, k, theta, 1.0, 1.0)[2]) for f in f0s])
    i = np.arange(M_t)[None, :]
    x = (np.clip(2.0 * i / N_t[:, None], 0.0, 2.0) - 1.0) / 2.0
    u0 = p_as[:, None] * np.cos(np.pi * x) ** 2 * (i < N_t[:, None] + 1)
    arrays = [np.repeat(f0s[:, None], T, axis=1), np.full(B, kappa), np.ones(B),
              np.full(B, 0.5), np.tile(np.array(T60S)[None], (B, 1, 1)), u0, u0,
              np.zeros((B, M_l)), np.zeros((B, M_l))]
    kw = dict(k=k, theta_t=float(theta), lambda_c=1.0, M_t=M_t, M_l=M_l,
              coupling_iters=24, relative_error=8.0, collect_state=True,
              manufactured=True, gmres_rescue=False)
    return [np.asarray(a, dtype) for a in arrays], p_as.astype(dtype), kw, N_t


def closed_form_error(state_u, f0, sr, N_t, p_a, T60=T60S, kappa=0.03):
    """Largest deviation of ``state_u`` (T, M) (steps 2..T+1) from the
    closed form, relative to ``p_a``."""
    gamma = 2.0 * f0
    sig0 = float(T60_to_sigma(np.asarray(T60), np.array([gamma]),
                              np.array([kappa * gamma]))[0][0])
    T = state_u.shape[0]
    exact = manufactured_solution(T + 2, N_t + 1, gamma, sig0, p_a, sr)[2:]
    return np.abs(state_u[:, : N_t + 1] - exact).max() / p_a


def _jax(arrays, p_a, kw, T, centered):
    import jax.numpy as jnp

    uout, zout, aux = jax_string_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=T, batch_block=1, interpret=True,
        mms_centered=centered, p_a=jnp.asarray(p_a), **kw)
    return (np.asarray(uout), np.asarray(zout), np.asarray(aux["state_u"]),
            np.asarray(aux["state_z"]), [np.asarray(c) for c in aux["carry"]])


def _port(arrays, p_a, kw, centered, fn=sk.string_chunked):
    uout, zout, aux = fn(*(torch.from_numpy(a) for a in arrays),
                         mms_centered=centered, p_a=torch.from_numpy(p_a), **kw)
    return (uout.numpy(), zout.numpy(), aux["state_u"].numpy(),
            aux["state_z"].numpy(), [c.numpy() for c in aux["carry"]])


@pytest.mark.parametrize("centered", [False, True], ids=["reference-time", "centered"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_plain_mms_matches_jax_kernel(dtype, centered):
    """Two strings of different f0 and p_a, 128 steps.  float64: every
    field within 1e-9 of its scale (z against max(|z|, |u|), as the f64
    slice tests measure it).  float32: the bounds of
    test_pallas_kernel.py:53-58 (state 1.2e-5 absolute and 6e-4 of scale,
    readouts 2e-4 of scale)."""
    T = 128
    arrays, p_a, kw, _ = mms_inputs([220.0, 262.0], 48000, T, [0.01, 0.004], dtype=dtype)
    want = _jax(arrays, p_a, kw, T, centered)
    got = _port(arrays, p_a, kw, centered)
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()
    su_scale = np.abs(want[2]).max()
    if dtype == np.float64:
        for name, g, w in zip(("uout", "zout", "state_u", "state_z"), got, want):
            w = w[:, :, : g.shape[2]] if w.ndim == 3 else w
            scale = max(np.abs(w).max(), su_scale if "z" in name else 0.0)
            assert np.abs(g - w).max() <= 1e-9 * scale, name
        return
    for name, g, w in zip(("uout", "zout"), got[:2], want[:2]):
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max(), name
    for name, g, w in (("state_u", got[2], want[2]), ("state_z", got[3], want[3]),
                       ("u1", got[4][0], want[4][0]), ("z1", got[4][2], want[4][2])):
        w = w[..., : g.shape[-1]]
        err = np.abs(g - w).max()
        assert err < 1.2e-5 and err < 6e-4 * su_scale, (name, err)


def test_plain_mms_tracks_closed_form_and_converges():
    """Twin of test_pallas_kernel.py::test_pallas_mms_tracks_closed_form_and_converges
    on the plain version (float64, centered forcing): within 2% of p_a of the
    closed form over 1024 steps at 48 kHz, and at least 1.7 times closer at
    96 kHz over the same horizon (second order)."""
    errs = []
    for sr, T in ((48000, 1024), (96000, 2048)):
        arrays, p_a, kw, N_t = mms_inputs([220.0], sr, T, [0.01])
        su = _port(arrays, p_a, kw, True)[2][:, 0]
        errs.append(closed_form_error(su, 220.0, sr, int(N_t[0]), 0.01))
    err_coarse, err_fine = errs
    assert err_coarse < 0.02, err_coarse
    assert err_fine < err_coarse / 1.7, (err_fine, err_coarse)


def test_mms_amplitude_through_the_bucketed_launch():
    """p_a reaches each string through the bucketed launch's row map: a
    batch of 32 strings in two width groups, each string's own amplitude,
    equal to the unbucketed call within each group's width (float64, 1e-12
    of scale), and each string within 2% of its own closed form."""
    T = 64
    f0s = np.where(np.arange(32) % 2 == 0, 110.0, 330.0)
    p_as = 0.002 + 0.0005 * np.arange(32)
    arrays, p_a, kw, N_t = mms_inputs(f0s, 48000, T, p_as)
    groups = sk.bucket_groups(arrays[0], arrays[1], arrays[2], k=kw["k"],
                              theta_t=kw["theta_t"], lambda_c=1.0, M_t=kw["M_t"],
                              M_l=kw["M_l"])
    assert len(groups) == 2
    tensors = [torch.from_numpy(a) for a in arrays]
    pa_t = torch.from_numpy(p_a)
    bu, _, baux = sk.string_chunked_bucketed(*tensors, p_a=pa_t, **kw)
    fu, _, faux = sk.string_chunked(*tensors, p_a=pa_t, **kw)
    assert np.abs(bu.numpy() - fu.numpy()).max() <= 1e-12 * np.abs(fu.numpy()).max()
    for w, rows in groups:
        b_su = baux["state_u"][:, rows, :w].numpy()
        f_su = faux["state_u"][:, rows, :w].numpy()
        assert np.abs(b_su - f_su).max() <= 1e-12 * np.abs(f_su).max()
    su = baux["state_u"].numpy()
    for b in (0, 1, 30, 31):
        err = closed_form_error(su[:, b], f0s[b], 48000, int(N_t[b]), p_as[b])
        assert err < 0.02, (b, err)
    with pytest.raises(ValueError, match="p_a"):
        sk.string_chunked_bucketed(*tensors, **kw)


def _linear_string_draw(precision, T):
    """linear-string's own first draw (its composed config, seed proc.seed)
    at ``precision``: one string, M_t 283 / M_l 437, relative_error 8, the
    forcing at the uncentered time level; ``string_chunked``'s CPU args and
    kwargs over its first ``T`` steps."""
    from torch_fdtd_string_tpu_torch.run import CONFIG_DIR
    from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
    from torch_fdtd_string_tpu_torch.utils.config import compose

    args = compose(CONFIG_DIR, ["experiment=linear-string", f"task.precision={precision}",
                                "task.plot=false", "task.plot_state=false"])
    task = args.task
    kw = tsim.task_kwargs(task)
    theta = kw.pop("theta_t")
    string, _, _, bm, hm, _ = tsim.draw_params(
        "pluck", task.sr, theta, task.length, task.batch_size, task.f0_inf,
        task.alpha_inf, task.lambda_c, precision=task.precision,
        randomize_each=task.randomize_each, manufactured=task.manufactured,
        rng=np.random.default_rng(args.proc.seed), **kw)
    consts = tsim.sim_consts(string, bm, hm, task.sr, theta, task.lambda_c,
                             relative_order=task.relative_order,
                             surface_integral=task.surface_integral,
                             manufactured=task.manufactured, collect_state=True)
    fa, fkw = tsim.kernel_inputs(string, consts, int(task.length * task.sr),
                                 torch.device("cpu"))
    return (fa[0][:, :T].contiguous(),) + fa[1:], fkw


def test_plain_mms_gmres_matches_jax_kernel_at_linear_string():
    """The MMS GMRES instance's plain version against the JAX kernel in
    interpret mode (batch_block=1) at linear-string's own draw in its
    configured float64, with coupling_iters=1, so that every step goes
    through GMRES: every field within 1e-9 of its scale over 8 steps."""
    import jax.numpy as jnp

    T = 8
    args, kw = _linear_string_draw("double", T)
    assert (kw["M_t"], kw["M_l"], kw["relative_error"]) == (283, 437, 8.0)
    assert kw["manufactured"] and not kw["mms_centered"]
    kw = dict(kw, gmres_rescue=True, coupling_iters=1)
    uout, zout, aux = sk.string_chunked(*args, **kw)
    assert (aux["gmres_iters"] > 0).all()
    p_a = jnp.asarray(kw.pop("p_a").numpy())
    ju, jz, jaux = jax_string_chunked(*(jnp.asarray(a.numpy()) for a in args), chunk=T,
                                      batch_block=1, interpret=True, p_a=p_a, **kw)
    pairs = [("uout", uout, ju), ("zout", zout, jz),
             ("state_u", aux["state_u"], jaux["state_u"]),
             ("state_z", aux["state_z"], jaux["state_z"])]
    for name, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)[..., : g.shape[-1]]
        assert g.dtype == np.float64 and np.isfinite(g).all(), name
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-9 * scale, (name, err / scale)
