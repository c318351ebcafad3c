"""The port's bowed, hammered and mixed dataset-generation path against the
JAX package's.

Both packages' ``tasks/simulate.run`` generate the same nsynth-like batch in
this process (CPU: the JAX scan engine, the port's plain string step) with
every string bowed (``bow``), hammered (``hammer``) or drawn per string
(``random``, ``model.excitation=null``), from the same seed, with the
classic archival artifacts.  Seed 16 draws the ``random`` batch of three as
one bowed, one hammered and one plucked string.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from test_torch_simulate import BASE, CONFIG_DIR, _bundles, _check_common, _items
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

# task.relative_order=12: see test_simulate_excitation_double_matches_jax
EXC = BASE + ["task.num_samples=1", "task.batch_size=3", "task.length=0.02",
              "proc.seed=16", "task.relative_order=12"]
MODELS = ["bow", "hammer", "random"]
LABELS = {"bow": {"bow"}, "hammer": {"hammer"}, "random": {"bow", "hammer", "pluck"}}
TRACES = ("v_r_out", "F_H_out", "u_H_out")


def _run_both(tmp_path, model_name, overrides):
    out = {}
    for tag, compose, sim in (("jax", jcompose, jsim), ("torch", tcompose, tsim)):
        d = tmp_path / tag
        d.mkdir()
        sim.run(compose(CONFIG_DIR, overrides), str(d), model_name, 1)
        out[tag] = str(d)
    return out["jax"], out["torch"]


def _check_excitation(jdir, tdir, model_name):
    """Identical excitation draws and labels, and the run really holds the
    excitation kinds its model name asks for."""
    labels = set()
    for item in _items(tdir):
        for name in ("bow_params.npz", "hammer_params.npz"):
            js = np.load(os.path.join(jdir, item, name))
            ts = np.load(os.path.join(tdir, item, name))
            assert js.files == ts.files, name
            for key in js.files:
                assert js[key].dtype == ts[key].dtype, (name, key)
                np.testing.assert_array_equal(js[key], ts[key], err_msg=f"{name} {key}")
        conf = []
        for d in (jdir, tdir):
            with open(os.path.join(d, item, "simulation_config.yaml")) as f:
                conf.append(yaml.safe_load(f))
        assert conf[0] == conf[1], item
        jz, tz = _bundles(jdir, tdir, item)
        for key in ("bow_mask", "hammer_mask", "pluck_mask"):
            np.testing.assert_array_equal(jz[key], tz[key], err_msg=key)
        labels |= {kind for kind in ("bow", "hammer", "pluck") if tz[f"{kind}_mask"]}
    assert labels == LABELS[model_name]


def _scale(x):
    return max(np.abs(x).max(), 1e-300)


@pytest.mark.parametrize("model_name", MODELS)
def test_simulate_excitation_single_matches_jax(tmp_path, model_name):
    """float32: the bounds of test_torch_simulate.py for pluck over the first
    256 steps, F_H within 1e-3 of scale (test_pallas_kernel.py:149) and the
    other probe traces at the readout bound.

    The readouts and the bow's probe velocity are velocities: sums of
    u-differences over k (the surface integral sums (u_n - u_{n-1}) h_t / k,
    v_r sums rc (u_c - u_{n-1}) / k).  The string kernel leaves its sweeps
    once they move u by no more than 100 f32 eps of max|u|, where the
    engine's Picard loop stops by another rule, and a bowed string's sweeps
    end near that bound.  So each is held to the larger of the readout bound
    and that exit tolerance over k."""
    jdir, tdir = _run_both(tmp_path, model_name, EXC)
    _check_common(jdir, tdir)
    _check_excitation(jdir, tdir, model_name)
    inner_eps = 100.0 * float(np.finfo(np.float32).eps)
    for item in _items(tdir):
        jz, tz = _bundles(jdir, tdir, item)
        assert tz["state_u"].dtype == np.float32
        scale = np.abs(jz["state_u"][:258]).max()
        for key in ("state_u", "state_z"):
            assert jz[key].shape == tz[key].shape
            err = np.abs(jz[key][:258] - tz[key][:258]).max()
            assert err < 1.2e-5 and err < 6e-4 * scale, (item, key, err)
        for key, bound in (("uout", 2e-4), ("zout", 2e-4), ("v_r_out", 2e-4),
                           ("u_H_out", 2e-4), ("F_H_out", 1e-3)):
            j, t = jz[key][:256], tz[key][:256]
            lim = bound * _scale(j)
            if key == "F_H_out":
                lim = bound * max(_scale(j), 1.0)
            if key in ("uout", "zout", "v_r_out"):
                lim = max(lim, inner_eps * scale * 48000.0)  # k = 1 / 48 kHz
            assert np.abs(j - t).max() <= lim, (item, key, np.abs(j - t).max(), lim)
        for key in ("uout", "zout", "state_u", "state_z") + TRACES:
            assert jz[key].shape == tz[key].shape, (item, key)
            assert np.isfinite(tz[key]).all(), (item, key)


def check_double(tmp_path, model_name):
    """float64 at 1e-9 of each field's own scale over whole trajectories
    (readings: 5e-12 at most).  The JAX engine stops its Picard loop once an
    iterate moves u by no more than h_t**relative_order, where the string
    kernel iterates to machine precision (see tests/test_torch_golden.py),
    so both run with ``task.relative_order=12``: below f64 resolution, the
    engine's loop converges too."""
    jdir, tdir = _run_both(tmp_path, model_name, EXC + ["task.precision=double"])
    _check_common(jdir, tdir)
    _check_excitation(jdir, tdir, model_name)
    for item in _items(tdir):
        jz, tz = _bundles(jdir, tdir, item)
        for key in ("state_u", "state_z", "uout", "zout") + TRACES:
            assert jz[key].shape == tz[key].shape and tz[key].dtype == np.float64, key
            err = np.abs(jz[key] - tz[key]).max()
            assert err <= 1e-9 * _scale(jz[key]), (item, key, err / _scale(jz[key]))


# the float64 runs of the bowed and the hammered batch are
# tests/test_torch_simulate_excitation_double.py (each float64 run is
# minutes of the eager engine on the CPU; two files share them out)
@pytest.mark.parametrize("model_name", ["random"])
def test_simulate_excitation_double_matches_jax(tmp_path, model_name):
    check_double(tmp_path, model_name)


def test_single_precision_without_a_card_raises(monkeypatch):
    """A ``proc.cpu=false`` single-precision run asks for the card; without
    one it stops instead of running the plain version on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        tsim.select_device(cpu=False, precision="single")
    assert tsim.select_device(cpu=True, precision="single").type == "cpu"
    assert tsim.select_device(cpu=True, precision="double").type == "cpu"
