"""The port's fused string step against the JAX Pallas kernel.

``string_chunked`` on CPU tensors runs its plain PyTorch version; the JAX
side runs ``pluck_chunked`` in Pallas interpret mode, as
tests/test_pallas_kernel.py does.  The CUDA kernel itself is held to the
plain version on the card by chip_smoke.py (the card's host has no JAX).
"""

import numpy as np
import pytest
import torch

import bench
from torch_fdtd_string_tpu.ops.pallas_step import pluck_chunked
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.ops import tridiag as td

T = 256


@pytest.fixture(scope="module")
def workload():
    args, B, _, _ = bench.build_workload(B=4, length=0.02, seed=7)
    return args


def _inputs(workload, dtype, T=T):
    carry, _, sp, _, _, _, _, consts = workload
    arrays = (sp.f0[:, 2 : 2 + T], sp.kappa, sp.alpha, sp.pos, sp.T60,
              carry.u1, carry.u2, carry.z1, carry.z2)
    kw = dict(k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
              M_t=consts.M_t, M_l=consts.M_l, coupling_iters=24,
              surface_integral=True, collect_state=True, gmres_rescue=False)
    return [np.array(a, dtype) for a in arrays], kw


def _jax(arrays, kw):
    import jax.numpy as jnp

    uout, zout, fin = pluck_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=T // 2, interpret=True, **kw)
    return (np.asarray(uout), np.asarray(zout),
            [np.asarray(x) for x in fin[:4]], np.asarray(fin[4]), np.asarray(fin[5]))


def _port(arrays, kw, dtype):
    uout, zout, aux = sk.string_chunked(
        *(torch.tensor(a, dtype=dtype) for a in arrays), **kw)
    return (uout.numpy(), zout.numpy(), [x.numpy() for x in aux["carry"]],
            aux["state_u"].numpy(), aux["state_z"].numpy())


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_reference_matches_pallas_f64(workload):
    """Both iterate to f64 machine-precision convergence (the JAX kernel and
    engine agree to 4e-15 there, test_pallas_kernel.py:50-52)."""
    arrays, kw = _inputs(workload, np.float64)
    want = _jax(arrays, kw)
    got = _port(arrays, kw, torch.float64)
    for name, g, w in zip(("uout", "zout"), got[:2], want[:2]):
        assert _rel(g, w) < 1e-10, name
    for j, (g, w) in enumerate(zip(got[2], want[2])):
        scale = max(np.abs(want[2][0]).max(), np.abs(want[2][2]).max()) if j >= 2 else None
        assert np.abs(g - w).max() < 1e-10 * (scale or np.abs(w).max()), j
    assert _rel(got[3], want[3]) < 1e-10
    assert _rel(got[4], want[4]) < 1e-10


def test_reference_matches_pallas_f32(workload):
    """f32 rounding compounds over 256 steps: the bounds of
    test_pallas_kernel.py:53-58 (state atol 1.2e-5 and < 6e-4 scale,
    readout < 2e-4 relative)."""
    arrays, kw = _inputs(workload, np.float32)
    want = _jax(arrays, kw)
    got = _port(arrays, kw, torch.float32)
    assert np.isfinite(got[0]).all()
    for name, g, w in zip(("uout", "zout"), got[:2], want[:2]):
        assert _rel(g, w) < 2e-4, name
    scale = np.abs(want[3]).max()
    for name, g, w in (("state_u", got[3], want[3]), ("state_z", got[4], want[4]),
                       ("u1", got[2][0], want[2][0]), ("u2", got[2][1], want[2][1]),
                       ("z1", got[2][2], want[2][2]), ("z2", got[2][3], want[2][3])):
        err = np.abs(g - w).max()
        assert err < 1.2e-5 and err < 6e-4 * scale, (name, err)


def test_diverged_element_does_not_poison_batch(workload):
    """Twin of test_pallas_kernel.py::test_diverged_element_does_not_poison_batch:
    a NaN string's readout is NaN in both packages, and in the port every
    other string's result is bit-identical with or without it in the batch
    (each string leaves its sweep loop on its own)."""
    arrays, kw = _inputs(workload, np.float32, T=128)
    arrays[5][0, :] = np.nan  # string 0's u1
    ju, jz, *_ = _jax(arrays, kw)
    tu, tz, tcarry, tsu, tsz = _port(arrays, kw, torch.float32)
    assert np.isnan(ju[0]).all() and np.isnan(tu[0]).all()
    np.testing.assert_array_equal(np.isnan(tu), np.isnan(ju))
    np.testing.assert_array_equal(np.isnan(tz), np.isnan(jz))
    assert np.isfinite(tu[1:]).all() and np.isfinite(tsu[:, 1:]).all()

    sub = [a[1:] for a in arrays]
    su, sz, scarry, ssu, ssz = _port(sub, kw, torch.float32)
    np.testing.assert_array_equal(tu[1:], su)
    np.testing.assert_array_equal(tz[1:], sz)
    np.testing.assert_array_equal(tsu[:, 1:], ssu)
    np.testing.assert_array_equal(tsz[:, 1:], ssz)
    for a, b in zip(tcarry, scarry):
        np.testing.assert_array_equal(a[1:], b)


def test_dispatch_counts_only_kernel_launches(workload):
    """CPU tensors take the plain version and do not count as launches; a
    device the port has no path for raises instead of falling back."""
    arrays, kw = _inputs(workload, np.float32, T=4)
    before = dict(sk.string_chunked.launches_by_spec)
    uout, zout, aux = sk.string_chunked(*(torch.tensor(a) for a in arrays), **kw)
    assert sk.string_chunked.launches_by_spec == before
    B, M_t, M_l = 4, kw["M_t"], kw["M_l"]
    assert uout.shape == zout.shape == (B, 4) and uout.dtype == torch.float32
    assert aux["state_u"].shape == (4, B, M_t)
    assert aux["state_z"].shape == (4, B, M_l)
    assert [tuple(c.shape) for c in aux["carry"]] == [(B, M_t), (B, M_t),
                                                      (B, M_l), (B, M_l)]
    with pytest.raises(ValueError, match="unsupported device"):
        sk.string_chunked(*(torch.tensor(a, device="meta") for a in arrays), **kw)


def test_padded_width_and_levels():
    assert sk.padded_width(172, 262) == 288
    assert sk.padded_width(3, 5) == 32
    # the partitioned solve's reduced system: two rows per lane of a warp,
    # reached across by its PCR levels
    assert 2 ** td.REDUCED_LEVELS == 2 * td.LANES == 64

