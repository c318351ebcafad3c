"""The port's excited string step against the JAX Pallas kernel.

Bowed, hammered and mixed (bow + hammer + pluck) strings built from
tests/test_pallas_kernel.py::_exc_cfg go through the port's plain version
(``string_chunked`` on CPU tensors) and the JAX ``string_chunked`` in Pallas
interpret mode with ``batch_block=1``, so that the JAX kernel's batch-wide
exits (the Gauss-Seidel sweeps and the hammer's inner fixed point) are
per-string like the port's.  Both readouts are covered.  The CUDA kernel
itself is held to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from test_pallas_kernel import _exc_cfg
from torch_fdtd_string_tpu.ops.pallas_step import string_chunked as jax_string_chunked
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

T = 128
KINDS = {"bow": ["bow"], "hammer": ["hammer"], "mix": ["bow", "hammer", "pluck"]}


def _inputs(case, dtype, T=T):
    """Numpy inputs of one case: the first string of each kind's fixture,
    padded with zeros to the widest allocation of the case."""
    cfgs = [_exc_cfg(kind)[0] for kind in KINDS[case]]
    M_t = max(c["M_t"] for c in cfgs)
    M_l = max(c["M_l"] for c in cfgs)
    B = len(cfgs)

    def cat(key, width=None):
        rows = []
        for c in cfgs:
            x = np.asarray(c[key], np.float64)[:1]
            if width is not None:
                x = np.pad(x, ((0, 0), (0, width - x.shape[1])))
            rows.append(x)
        return np.concatenate(rows).astype(dtype)

    sig = lambda key: np.ascontiguousarray(cat(key)[:, 2 : 2 + T])
    k = cfgs[0]["k"]
    uH1 = np.array([-1e-3 + k * c["v_H_amp"] for c in cfgs], dtype)
    uH2 = np.full(B, -1e-3, dtype)
    bmask = np.concatenate([c["bow_mask"][:1] for c in cfgs])
    hmask = np.concatenate([c["hammer_mask"][:1] for c in cfgs])
    arrays = [sig("f0"), cat("kappa"), cat("alpha"), cat("pos"), cat("T60"),
              cat("u1", M_t), cat("u2", M_t), np.zeros((B, M_l), dtype),
              np.zeros((B, M_l), dtype)]
    bow = hammer = None
    if bmask.any():
        bow = dict(x_b=sig("x_b"), v_b=sig("v_b"), F_b=sig("F_b"), wid=sig("wid"),
                   phi_0=cat("phi_0"), phi_1=cat("phi_1"), mask=bmask,
                   uH1=uH1, uH2=uH2)
    if hmask.any():
        hammer = dict(x_H=cat("x_H"), w_H=cat("w_H"), M_r=cat("M_r"),
                      alpha=cat("alpha_H"), mask=hmask, uH1=uH1, uH2=uH2)
    kw = dict(k=k, theta_t=cfgs[0]["theta_t"], lambda_c=1.0, M_t=M_t, M_l=M_l,
              coupling_iters=24, collect_state=True, gmres_rescue=False)
    return arrays, bow, hammer, kw


def _jax(arrays, bow, hammer, kw, surface_integral):
    import jax.numpy as jnp

    j = lambda d: None if d is None else {key: jnp.asarray(v) for key, v in d.items()}
    uout, zout, aux = jax_string_chunked(
        *(jnp.asarray(a) for a in arrays), bow=j(bow), hammer=j(hammer),
        chunk=arrays[0].shape[1] // 2, batch_block=1, interpret=True,
        surface_integral=surface_integral, **kw)
    out = {"uout": uout, "zout": zout, **aux}
    out["carry"] = tuple(np.asarray(x) for x in aux["carry"])
    return {key: v if key == "carry" else np.asarray(v) for key, v in out.items()}


def _port(arrays, bow, hammer, kw, surface_integral, dtype):
    t = lambda d: None if d is None else {key: torch.tensor(v) for key, v in d.items()}
    uout, zout, aux = sk.string_chunked(
        *(torch.tensor(a, dtype=dtype) for a in arrays), bow=t(bow),
        hammer=t(hammer), surface_integral=surface_integral, **kw)
    out = {"uout": uout.numpy(), "zout": zout.numpy()}
    out.update({key: v.numpy() for key, v in aux.items() if key != "carry"})
    out["carry"] = tuple(x.numpy() for x in aux["carry"])
    return out


def _err(got, want):
    return np.abs(got - want).max(), max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("surface_integral", [True, False], ids=["surface", "pickup"])
@pytest.mark.parametrize("case", sorted(KINDS))
def test_reference_matches_pallas_f64(case, surface_integral):
    """Both iterate to f64 machine-precision convergence: 1e-10 of scale,
    as tests/test_torch_string_kernel.py::test_reference_matches_pallas_f64.
    ``z`` fields are measured against max(|z|, |u|), as the golden fixtures
    are: the sweeps converge relative to the transverse displacement."""
    arrays, bow, hammer, kw = _inputs(case, np.float64)
    want = _jax(arrays, bow, hammer, kw, surface_integral)
    got = _port(arrays, bow, hammer, kw, surface_integral, torch.float64)
    scale_u = np.abs(want["state_u"]).max()
    pairs = [(key, got[key], want[key]) for key in
             ("uout", "zout", "state_u", "state_z", "v_r", "F_H", "u_H")]
    pairs += [(f"carry{j}", g, w) for j, (g, w) in
              enumerate(zip(got["carry"], want["carry"]))]
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        err, scale = _err(g, w)
        if name in ("state_z", "carry2", "carry3"):
            scale = max(scale, scale_u)
        assert err <= 1e-10 * scale, (name, err / scale)


@pytest.mark.parametrize("surface_integral", [True, False], ids=["surface", "pickup"])
@pytest.mark.parametrize("case", sorted(KINDS))
def test_reference_matches_pallas_f32(case, surface_integral):
    """f32 rounding compounds over the steps: state 1.2e-5 absolute and
    under 6e-4 of scale, readouts 2e-4 of scale (test_pallas_kernel.py:53-58),
    F_H 1e-3 of scale (test_pallas_kernel.py:149), v_r and u_H at the
    readout bound.  zout is held per string against its own scale at 2e-3:
    an excited string barely moves z (its zout is 1e-5 to 1e-7 of its
    uout), and z's f32 error follows u's; the largest reading here is
    3.5e-4 (bowed, pickup), and a zout of 0 reads 1."""
    arrays, bow, hammer, kw = _inputs(case, np.float32)
    want = _jax(arrays, bow, hammer, kw, surface_integral)
    got = _port(arrays, bow, hammer, kw, surface_integral, torch.float32)
    scale = np.abs(want["state_u"]).max()
    for name in ("uout", "zout", "state_u", "state_z", "v_r", "F_H", "u_H"):
        assert np.isfinite(got[name]).all(), name
    states = [("state_u", got["state_u"], want["state_u"]),
              ("state_z", got["state_z"], want["state_z"])]
    states += [(f"carry{j}", g, w) for j, (g, w) in
               enumerate(zip(got["carry"], want["carry"]))]
    for name, g, w in states:
        err = np.abs(g - w).max()
        assert err < 1.2e-5 and err < 6e-4 * scale, (name, err)
    for name, bound in (("uout", 2e-4), ("v_r", 2e-4), ("u_H", 2e-4), ("F_H", 1e-3)):
        err, ref = _err(got[name], want[name])
        if name == "F_H":
            ref = max(ref, 1.0)
        assert err <= bound * ref, (name, err, ref)
    err_z = np.abs(got["zout"] - want["zout"]).max(axis=1)
    scale_z = np.abs(want["zout"]).max(axis=1)
    assert (scale_z > 0).all() and (err_z <= 2e-3 * scale_z).all(), (err_z, scale_z)


def test_excitation_traces_are_not_masked():
    """A plucked string in a mixed batch keeps its v_r probe and follows the
    hammer formulas, as the JAX kernel writes them; the bow-less hammer
    string has v_r from the bow's formula too."""
    arrays, bow, hammer, kw = _inputs("mix", np.float64, T=16)
    got = _port(arrays, bow, hammer, kw, True, torch.float64)
    want = _jax(arrays, bow, hammer, kw, True)
    assert np.abs(got["v_r"][2]).max() > 0.0  # the pluck string
    np.testing.assert_allclose(got["v_r"], want["v_r"], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got["u_H"], want["u_H"], rtol=1e-10, atol=1e-14)


def test_diverged_element_does_not_poison_batch():
    """Excitation twin of test_pallas_kernel.py::
    test_diverged_element_does_not_poison_batch: the bowed string's u1 is
    NaN.  Every trace has the JAX kernel's NaN mask, and every other
    string's result is bit-identical with or without it in the batch."""
    arrays, bow, hammer, kw = _inputs("mix", np.float32)
    arrays[5][0, :] = np.nan
    want = _jax(arrays, bow, hammer, kw, True)
    got = _port(arrays, bow, hammer, kw, True, torch.float32)
    assert np.isnan(got["uout"][0]).all() and np.isnan(want["uout"][0]).all()
    for name in ("uout", "zout", "v_r", "F_H", "u_H"):
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(want[name]),
                                      err_msg=name)
    assert np.isfinite(got["uout"][1:]).all()
    assert np.isfinite(got["state_u"][:, 1:]).all()

    # the bow dict stays, all its masks False: the same specialization
    sub = lambda d: {key: v[1:] for key, v in d.items()}
    part = _port([a[1:] for a in arrays], sub(bow), sub(hammer), kw, True,
                 torch.float32)
    for name in ("uout", "zout", "v_r", "F_H", "u_H"):
        np.testing.assert_array_equal(got[name][1:], part[name], err_msg=name)
    for name in ("state_u", "state_z"):
        np.testing.assert_array_equal(got[name][:, 1:], part[name], err_msg=name)
    for a, b in zip(got["carry"], part["carry"]):
        np.testing.assert_array_equal(a[1:], b)


def test_specialization_names():
    arrays, bow, hammer, kw = _inputs("mix", np.float32, T=4)
    names = set()
    for b in (None, bow):
        for h in (None, hammer):
            for si in (True, False):
                c = sk._consts(bow=b, hammer=h, surface_integral=si,
                               relative_error=4.0, manufactured=False,
                               coupling_fixed=0, M_t_sem=None,
                               **{key: kw[key] for key in (
                                   "k", "theta_t", "lambda_c", "M_t", "M_l",
                                   "coupling_iters", "collect_state",
                                   "gmres_rescue")})
                names.add(c.name)
    assert names == {"pluck", "bow", "hammer", "mix", "pluck-pickup",
                     "bow-pickup", "hammer-pickup", "mix-pickup"}


def test_launch_args_layout():
    """The ctypes mirror of csrc/string_step.cu::LaunchArgs: 18 ints, 4
    doubles, 36 pointers (the bucketed launch's row map first), natural
    alignment (the kernel compares struct_size with its own sizeof)."""
    import ctypes
    import re

    fields = sk._LaunchArgs._fields_
    assert [f[1] for f in fields] == ([ctypes.c_int] * 18 + [ctypes.c_double] * 4
                                      + [ctypes.c_void_p] * 36)
    # 18 ints fill 72 bytes, a multiple of the doubles' alignment
    assert ctypes.sizeof(sk._LaunchArgs) == 72 + 4 * 8 + 36 * 8
    src = open(sk.__file__.replace("ops/string_kernel.py", "csrc/string_step.cu")).read()
    body = src[src.index("struct LaunchArgs {"):]
    body = body[: body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = re.sub(r"^\s*(const\s+)?(int|double|float)\s+", "", line).rstrip("; ")
        names += [n.strip().lstrip("*") for n in decl.split(",") if n.strip()]
    assert names == [f[0] for f in fields]
