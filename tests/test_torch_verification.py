"""The verification experiments and the float64 route against the JAX
package.

``experiment=linear-string`` (the manufactured-solution run) and
``experiment=nonlinear-string`` run at their float64 default through both
packages' ``tasks/simulate.run`` in this process, cut only in
``task.length`` and with the plots off.  Both take their scan engine, in
chunks of the configs' ``task.chunk_length``, and write the readout wavs
during the process (``task.write_during_process``); the port's are byte
for byte the JAX package's.  The bowed, hammered and mixed float64 runs are
held to the JAX package at the configs' own ``task.relative_order=4``,
where the string kernel's plain version departs from the engine.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_simulate import BASE, CONFIG_DIR, _bundles, _check_common, _items
from test_torch_simulate_excitation import EXC, TRACES, _check_excitation, _scale
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch.core.analytic import manufactured_solution
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils import wav as wavio
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

NO_PLOTS = ["task.plot=false", "task.plot_state=false", "task.randomize_name=false"]
FIELDS = ("state_u", "state_z", "uout", "zout") + TRACES


def _run_both(tmp_path, model_name, overrides):
    out = {}
    for tag, compose, sim in (("jax", jcompose, jsim), ("torch", tcompose, tsim)):
        d = tmp_path / tag
        d.mkdir()
        sim.run(compose(CONFIG_DIR, overrides), str(d), model_name, 1)
        out[tag] = str(d)
    return out["jax"], out["torch"]


def _during_process_wavs(d):
    """Relative paths of the wavs written during the process."""
    return sorted(os.path.relpath(os.path.join(root, n), d)
                  for root, _, names in os.walk(os.path.join(d, "0")) for n in names)


@pytest.mark.parametrize("experiment", ["linear-string", "nonlinear-string"])
def test_verification_run_matches_jax(tmp_path, experiment):
    """Whole float64 runs at the configs' relative_order=8, every field of
    simulation.npz within 1e-9 of its scale, the during-process wavs equal
    byte for byte and the normalized output wavs within one PCM_24 step.
    linear-string's state also tracks the manufactured solution."""
    over = [f"experiment={experiment}", "task.length=0.01", "proc.cpu=true"] + NO_PLOTS
    args = tcompose(CONFIG_DIR, over)
    assert args.task.precision == "double" and args.task.relative_order == 8
    assert args.task.write_during_process
    jdir, tdir = _run_both(tmp_path, "pluck", over)
    wavs = _during_process_wavs(tdir)
    assert wavs == _during_process_wavs(jdir)
    assert wavs == [os.path.join("0", "48000-0", n)
                    for n in ("output-u.wav", "output-z.wav", "output.wav")]
    for rel in wavs:
        assert filecmp.cmp(os.path.join(jdir, rel), os.path.join(tdir, rel),
                           shallow=False), rel
    for d in (jdir, tdir):  # compared: the rest of the run dirs as the slice tests
        shutil.rmtree(os.path.join(d, "0"))
    # the JAX package names its timing log by proc.cpu, the port by the
    # device that ran the batch: cpu_time.txt in both
    _check_common(jdir, tdir)
    (item,) = _items(tdir)
    jz, tz = _bundles(jdir, tdir, item)
    for key in FIELDS:
        assert jz[key].shape == tz[key].shape and tz[key].dtype == np.float64, key
        err = np.abs(jz[key] - tz[key]).max()
        assert err <= 1e-9 * _scale(jz[key]), (key, err / _scale(jz[key]))
    for name in ("output.wav", "output-u.wav", "output-z.wav"):
        a, b = (wavio.read(os.path.join(d, item, name))[0] for d in (jdir, tdir))
        assert np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() \
            <= 1.5 / 8388607, name
    if experiment == "linear-string":
        # the state against the manufactured solution at the forcing's
        # reference time level (mms_centered off): within 2% of p_a
        sp = np.load(os.path.join(tdir, item, "string_params.npz"))
        su = tz["state_u"]
        n_x = int(tz["Nx_t"][0]) + 1
        exact = manufactured_solution(su.shape[0], n_x, 2.0 * float(sp["f0"][0]),
                                      float(tz["sig0"]), float(sp["p_a"]), args.task.sr)
        err = np.abs(su[:, :n_x] - exact).max() / float(sp["p_a"])
        assert err < 0.02, err


@pytest.mark.parametrize("model_name", ["bow", "hammer", "random"])
def test_excitation_double_at_config_relative_order(tmp_path, model_name):
    """The float64 bowed, hammered and mixed runs at the configs' own
    task.relative_order=4: the port now takes the scan engine, as the JAX
    package does, and agrees to 1e-9 of each field's scale (the string
    kernel's plain version, which f64 runs took before, departs from the
    engine by 3.7e-2 on the bowed string at this order)."""
    over = [o for o in EXC if not o.startswith("task.relative_order")] + [
        "task.precision=double"]
    assert tcompose(CONFIG_DIR, over).task.relative_order == 4
    jdir, tdir = _run_both(tmp_path, model_name, over)
    _check_common(jdir, tdir)
    _check_excitation(jdir, tdir, model_name)
    for item in _items(tdir):
        jz, tz = _bundles(jdir, tdir, item)
        for key in FIELDS:
            assert jz[key].shape == tz[key].shape and tz[key].dtype == np.float64, key
            err = np.abs(jz[key] - tz[key]).max()
            assert err <= 1e-9 * _scale(jz[key]), (item, key, err / _scale(jz[key]))


def test_write_during_process_follows_the_engine(tmp_path):
    """task.write_during_process is honoured on the float64 engine route
    (the wavs of every chunk's end, the last one the whole run's readouts)
    and ignored on the string kernel's route, as in the JAX package."""
    over = BASE + ["task.write_during_process=true", "task.length=0.01",
                   "task.chunk_length=0.004", "task.num_samples=1", "task.batch_size=1"]
    for precision, wrote in (("double", True), ("single", False)):
        d = tmp_path / precision
        d.mkdir()
        tsim.run(tcompose(CONFIG_DIR, over + [f"task.precision={precision}"]), str(d),
                 "pluck", 1)
        assert os.path.isdir(os.path.join(d, "0")) == wrote
        if wrote:
            z = np.load(os.path.join(d, "0-0", "simulation.npz"))
            w, _ = wavio.read(os.path.join(d, "0", "48000-0", "output-u.wav"))
            w = np.asarray(w, np.float64).reshape(-1)
            assert w.shape == z["uout"].shape
            assert np.abs(w - np.clip(z["uout"], -1, 1)).max() <= 1.0 / 32767


def test_double_precision_without_a_card_raises(tmp_path, monkeypatch):
    """A float64 run asks for the card unless ``proc.cpu=true``: on a host
    without one, linear-string at its own ``task.precision=double`` stops
    before it simulates instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tcompose(CONFIG_DIR, ["experiment=linear-string", "task.length=0.01"] + NO_PLOTS)
    assert args.task.precision == "double" and not args.proc.cpu
    with pytest.raises(RuntimeError, match="proc.cpu=true"):
        tsim.run(args, str(tmp_path), "pluck", 1)
    assert not os.path.exists(os.path.join(tmp_path, "0-0"))
