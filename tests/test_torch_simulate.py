"""The port's pluck dataset-generation slice against the JAX package's.

Both packages' ``tasks/simulate.run`` generate the same nsynth-like batch in
this process (CPU: the JAX scan engine, the port's plain string step), from
the same seed, with the classic archival artifacts.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")
# the overrides test_pipeline.py::test_fused_preprocess_matches_classic runs
BASE = [
    "experiment=nsynth-like", "task.num_samples=2", "task.batch_size=2",
    "task.length=0.1", "task.chunk_length=0.1", "task.randomize_name=false",
    "proc.cpu=true", "task.fuse_preprocess=false",
]


def _run_both(tmp_path, overrides):
    out = {}
    for tag, compose, sim in (("jax", jcompose, jsim), ("torch", tcompose, tsim)):
        d = tmp_path / tag
        d.mkdir()
        sim.run(compose(CONFIG_DIR, overrides), str(d), "pluck", 1)
        out[tag] = str(d)
    return out["jax"], out["torch"]


def _items(d):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "*-*"))
                  if os.path.isdir(p))


def _check_common(jdir, tdir):
    """Same items, same artifact names, identical draws, same skips."""
    assert _items(jdir) == _items(tdir) and _items(tdir)
    top = lambda d: sorted(n for n in os.listdir(d) if n not in _items(d))
    assert top(jdir) == top(tdir) == ["cpu_time.txt", "skip_stats.json"]
    for item in _items(tdir):
        assert sorted(os.listdir(os.path.join(jdir, item))) == sorted(
            os.listdir(os.path.join(tdir, item)))
        js = np.load(os.path.join(jdir, item, "string_params.npz"))
        ts = np.load(os.path.join(tdir, item, "string_params.npz"))
        assert js.files == ts.files
        for key in js.files:
            assert js[key].dtype == ts[key].dtype, key
            np.testing.assert_array_equal(js[key], ts[key], err_msg=key)
    with open(os.path.join(jdir, "skip_stats.json")) as f:
        jstats = json.load(f)
    if isinstance(jstats, dict):
        # the JAX package wraps the list with its writer-phase timings once
        # any run in this process has timed a writer phase (a process-wide
        # accumulator), so what it writes depends on the tests run before
        jstats = jstats["batches"]
    with open(os.path.join(tdir, "skip_stats.json")) as f:
        tstats = json.load(f)
    assert jstats == tstats


def _bundles(jdir, tdir, item):
    return (np.load(os.path.join(jdir, item, "simulation.npz")),
            np.load(os.path.join(tdir, item, "simulation.npz")))


def test_simulate_single_matches_jax(tmp_path):
    """float32: the f32 bounds of test_pallas_kernel.py:53-58 over the
    first 256 steps (f32 rounding compounds along the trajectory)."""
    jdir, tdir = _run_both(tmp_path, BASE)
    _check_common(jdir, tdir)
    for item in _items(tdir):
        jz, tz = _bundles(jdir, tdir, item)
        assert jz["state_u"].shape == tz["state_u"].shape
        assert tz["state_u"].dtype == np.float32
        scale = np.abs(jz["state_u"][:258]).max()
        for key in ("state_u", "state_z"):
            err = np.abs(jz[key][:258] - tz[key][:258]).max()
            assert err < 1.2e-5 and err < 6e-4 * scale, (item, key, err)
        uo_j, uo_t = jz["uout"][:256], tz["uout"][:256]
        assert np.abs(uo_j - uo_t).max() < 2e-4 * np.abs(uo_j).max(), item
        assert np.isfinite(tz["uout"]).all() and np.isfinite(tz["state_u"]).all()


def test_simulate_double_matches_jax(tmp_path):
    """float64: both solve every step to f64 machine precision, so whole
    trajectories agree to 1e-9 relative.  As in test_golden_fixtures.py,
    state_z is measured against max(|state_z|, |state_u|): its sweeps
    converge relative to the transverse displacement."""
    jdir, tdir = _run_both(tmp_path, BASE + ["task.precision=double",
                                             "task.length=0.02"])
    _check_common(jdir, tdir)
    for item in _items(tdir):
        jz, tz = _bundles(jdir, tdir, item)
        scale_u = np.abs(jz["state_u"]).max()
        for key in ("state_u", "state_z", "uout"):
            assert jz[key].shape == tz[key].shape and tz[key].dtype == np.float64
            scale = np.abs(jz[key]).max()
            if key == "state_z":
                scale = max(scale, scale_u)
            err = np.abs(jz[key] - tz[key]).max()
            assert err <= 1e-9 * scale, (item, key, err / scale)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import torch_fdtd_string_tpu_torch.tasks.simulate\n"
        "import torch_fdtd_string_tpu_torch.tasks.process_training_data\n"
        "import torch_fdtd_string_tpu_torch.tasks.evaluate\n"
        "import torch_fdtd_string_tpu_torch.tasks.summarize\n"
        "import torch_fdtd_string_tpu_torch.tasks.preprocess_data\n"
        "import torch_fdtd_string_tpu_torch.ops.postproc\n"
        "import torch_fdtd_string_tpu_torch.ops.modal\n"
        "import torch_fdtd_string_tpu_torch.core.analytic\n"
        "import torch_fdtd_string_tpu_torch.utils.data\n"
        "import torch_fdtd_string_tpu_torch.utils.frequency\n"
        "import torch_fdtd_string_tpu_torch.run\n"
        "import torch_fdtd_string_tpu_torch.tasks.time_experiment\n"
        "import torch_fdtd_string_tpu_torch.tools.kernel_timing\n"
        "import torch_fdtd_string_tpu_torch.tools.profile_kernel\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or m.split('.')[0] == 'torch_fdtd_string_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("override,what", [
    ("task.plot=true", "plots"),
])
def test_unported_run_options_raise(tmp_path, override, what, monkeypatch):
    """The figures need matplotlib: without it ``task.plot=true`` raises an
    ImportError naming ``task.plot=false`` before any work."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = tcompose(CONFIG_DIR, BASE + [override])
    with pytest.raises(ImportError, match="task.plot=false"):
        tsim.run(args, str(tmp_path), "pluck", 1)
    assert not os.listdir(tmp_path)
