"""The string step's fixed sweep schedule (``coupling_fixed > 0``) in the
port.

``string_chunked`` on CPU tensors runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as
tests/test_pallas_kernel.py does.  The schedule runs exactly
``coupling_fixed`` plain Gauss-Seidel sweeps per step with no exit test,
so it poisons nothing and never takes the GMRES rescue, whatever
``gmres_rescue`` says.  The CUDA kernel is held to the plain version on the
card by chip_smoke.py (phase 3 (t)).
"""

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.ops.pallas_step import string_chunked as jax_string_chunked
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

T = 128


@pytest.fixture(scope="module")
def workload():
    args, _, _, _ = bench.build_workload(B=4, length=0.02, seed=11)
    return args


def _inputs(workload, dtype, T=T):
    carry, _, sp, _, _, _, _, consts = workload
    arrays = [np.array(a, dtype) for a in (sp.f0[:, 2 : 2 + T], sp.kappa, sp.alpha,
                                           sp.pos, sp.T60, carry.u1, carry.u2,
                                           carry.z1, carry.z2)]
    kw = dict(k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
              M_t=consts.M_t, M_l=consts.M_l, coupling_iters=24,
              surface_integral=True, collect_state=True)
    return arrays, kw


def _mix(B, T, dtype):
    """Bow on strings 0 and 2, hammer on 1, pluck on 3 (tests/test_torch_gmres.py)."""
    full = lambda v: np.full((B, T), v, dtype)
    bow = dict(x_b=full(0.25), v_b=full(0.2), F_b=full(50.0), wid=full(4.0),
               phi_0=np.full(B, 5.0, dtype), phi_1=np.full(B, 0.1, dtype),
               mask=np.array([1, 0, 1, 0], bool))
    hammer = dict(x_H=np.full(B, 0.35, dtype), w_H=np.full(B, 2500.0, dtype),
                  M_r=np.full(B, 5.0, dtype), alpha=np.full(B, 3.0, dtype),
                  mask=np.array([0, 1, 0, 0], bool),
                  uH1=np.full(B, -1e-3 + 2.5 / 48000, dtype), uH2=np.full(B, -1e-3, dtype))
    return dict(bow=bow, hammer=hammer)


def _fields(uout, zout, aux):
    out = {"uout": uout, "zout": zout, "state_u": aux["state_u"],
           "state_z": aux["state_z"]}
    out.update({key: aux[key] for key in ("v_r", "F_H", "u_H") if key in aux})
    return {key: np.asarray(v) for key, v in out.items()}


CASES = [(dt, n, rescue, "pluck") for dt in ("f64", "f32") for n in (1, 2)
         for rescue in (False, True)] + [("f64", 2, True, "mix"), ("f32", 2, False, "mix")]


@pytest.mark.parametrize("dt,fixed,rescue,excitation", CASES,
                         ids=[f"{d}-fixed{n}-{'gmres' if r else 'poison'}-{e}"
                              for d, n, r, e in CASES])
def test_plain_fixed_matches_jax_kernel(workload, dt, fixed, rescue, excitation):
    """float64: every field within 1e-9 of its scale (z against max(|z|,
    |u|)).  float32: the bounds of test_pallas_kernel.py:53-58 (state
    1.2e-5 absolute and 6e-4 of scale, readouts 2e-4, F_H 1e-3 of
    max(scale, 1))."""
    import jax.numpy as jnp

    dtype = {"f64": np.float64, "f32": np.float32}[dt]
    arrays, kw = _inputs(workload, dtype)
    kw.update(coupling_fixed=fixed, gmres_rescue=rescue)
    exc = _mix(4, T, dtype) if excitation == "mix" else {}
    want = _fields(*jax_string_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=T // 2, interpret=True,
        **{key: {k: jnp.asarray(v) for k, v in d.items()} for key, d in exc.items()},
        **kw))
    uout, zout, aux = sk.string_chunked(
        *(torch.from_numpy(a) for a in arrays),
        **{key: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
           for key, d in exc.items()}, **kw)
    assert "gmres_iters" not in aux  # no rescue with a fixed schedule
    assert (aux["sweeps"] == fixed).all()
    got = _fields(uout, zout, aux)
    assert sorted(got) == sorted(want)
    su_scale = np.abs(want["state_u"]).max()
    for key, w in want.items():
        g = got[key]
        w = w[..., : g.shape[-1]]
        assert np.isfinite(g).all(), key
        err = np.abs(g - w).max()
        scale = np.abs(w).max()
        if dt == "f64":
            if key in ("state_z", "zout"):
                scale = max(scale, su_scale if key == "state_z" else np.abs(want["uout"]).max())
            assert err <= 1e-9 * scale, (key, err / scale)
        elif key.startswith("state"):
            assert err < 1.2e-5 and err < 6e-4 * su_scale, (key, err)
        elif key == "F_H":
            assert err <= 1e-3 * max(scale, 1.0), (key, err)
        elif key == "zout" and exc:
            # an excited string's z is ~1e-5 of its u: held to u's scale
            assert err <= 2e-4 * np.abs(want["uout"]).max(), (key, err)
        else:
            assert err <= 2e-4 * scale, (key, err / scale)


def test_plain_fixed_sweeps_match_adaptive(workload):
    """Twin of test_pallas_kernel.py::test_pallas_fixed_sweeps_match_adaptive
    at its shape (B=4, 256 steps, float32): two unrolled sweeps reach the
    adaptive loop's fixed point, the final state within 2e-4 and the
    readout within 2e-3 of scale."""
    arrays, kw = _inputs(workload, np.float32, T=256)
    tensors = [torch.from_numpy(a) for a in arrays]
    u_ad, _, aux_ad = sk.string_chunked(*tensors, **kw)
    u_fx, _, aux_fx = sk.string_chunked(*tensors, coupling_fixed=2, **kw)
    fin_ad, fin_fx = aux_ad["carry"][0].numpy(), aux_fx["carry"][0].numpy()
    dev_state = np.abs(fin_fx - fin_ad).max() / (np.abs(fin_ad).max() + 1e-12)
    assert dev_state < 2e-4, dev_state
    dev_out = np.abs(u_fx.numpy() - u_ad.numpy()).max() / (np.abs(u_ad.numpy()).max() + 1e-12)
    assert dev_out < 2e-3, dev_out


def test_fixed_schedule_names_and_refusals():
    """A fixed schedule takes the instance without the rescue; a negative
    count is refused; the CUDA launcher, whose MMS and fixed-schedule
    instances are for plucked strings alone, refuses them with a bow or a
    hammer (and together) before it touches the card."""
    base = dict(k=1 / 48000, theta_t=0.5, lambda_c=1.0, M_t=40, M_l=60,
                coupling_iters=24, surface_integral=True, collect_state=False,
                bow=None, hammer=None, relative_error=4.0, manufactured=False,
                M_t_sem=None)
    assert sk._consts(coupling_fixed=2, gmres_rescue=True, **base).name == "pluck-fixed"
    assert sk._consts(coupling_fixed=0, gmres_rescue=True, **base).name == "pluck-gmres"
    mms = dict(base, manufactured=True)
    assert sk._consts(coupling_fixed=0, gmres_rescue=False, **mms).name == "pluck-mms"
    with pytest.raises(ValueError, match="coupling_fixed"):
        sk._consts(coupling_fixed=-1, gmres_rescue=False, **base)
    B, T = 2, 4
    args = [torch.zeros(B, T), torch.ones(B), torch.ones(B), torch.ones(B),
            torch.ones(B, 2, 2), torch.zeros(B, 40), torch.zeros(B, 40),
            torch.zeros(B, 60), torch.zeros(B, 60)]
    bow = _mix(B, T, np.float32)["bow"]
    bowed = dict(base, bow=bow)
    for c in (sk._consts(coupling_fixed=2, gmres_rescue=False, **bowed),
              sk._consts(coupling_fixed=0, gmres_rescue=False, **dict(bowed, manufactured=True)),
              sk._consts(coupling_fixed=2, gmres_rescue=False, **mms)):
        with pytest.raises(NotImplementedError, match="no path runs"):
            sk._launch_cuda(c, *args, bow if c.has_bow else None, None)
