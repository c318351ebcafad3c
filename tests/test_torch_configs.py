"""The port's own config tree (``torch_fdtd_string_tpu_torch/configs``).

The port composes its runs from a copy of the JAX package's tree, so that
it runs without the JAX package beside it.  The two trees hold the same
files byte for byte; every experiment, and every optimizer and scheduler
group on top of synth-dmsp, composes to the same tree from either; and a
copy of the port's package alone, in a process where importing ``jax`` or
the JAX package raises, runs ``experiment=nsynth-like`` on the CPU and
snapshots its config tree with its code.  The classic path
(``task.fuse_preprocess=false``) keeps that run off the modal solution's
root table, which a fresh copy would otherwise build first (~30 s).
"""

import datetime
import filecmp
import os
import shutil
import subprocess
import sys

import pytest

from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.utils import config as tconfig
from torch_fdtd_string_tpu_torch.utils.config import compose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def _groups(group):
    return sorted(os.path.splitext(f)[0]
                  for f in os.listdir(os.path.join(JAX_CONFIG_DIR, group)))


def test_the_trees_hold_the_same_files():
    assert trun.CONFIG_DIR == os.path.join(trun.PKG_DIR, "configs")
    names = _files(JAX_CONFIG_DIR)
    assert names == _files(trun.CONFIG_DIR)
    assert len(names) == 38
    _, mismatch, errors = filecmp.cmpfiles(JAX_CONFIG_DIR, trun.CONFIG_DIR, names,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])


@pytest.mark.parametrize("overrides", [[f"experiment={e}"] for e in _groups("experiment")]
                         + [["experiment=synth-dmsp", f"optimizer={o}"]
                            for o in _groups("optimizer")]
                         + [["experiment=synth-dmsp", f"scheduler={s}"]
                            for s in _groups("scheduler")],
                         ids=lambda o: "-".join(x.split("=")[1] for x in o))
def test_both_trees_compose_alike(overrides, monkeypatch):
    # one clock for both, so that the ${now:...} run names agree
    now = datetime.datetime(2024, 1, 2, 3, 4, 5, 6)
    monkeypatch.setattr(tconfig.datetime, "datetime",
                        type("Fixed", (datetime.datetime,), {"now": staticmethod(lambda: now)}))
    want = compose(JAX_CONFIG_DIR, overrides)
    got = compose(trun.CONFIG_DIR, overrides)
    assert got == want
    group, name = overrides[-1].split("=")
    if group != "experiment":  # the group the override chose was composed
        assert got[group]._name_ == name


# a process that refuses every import of jax and of the JAX package
STANDALONE = """
import importlib.abc, runpy, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "torch_fdtd_string_tpu"):
            raise ImportError(f"the standalone port imported {name}")
sys.meta_path.insert(0, Refuse())
sys.argv = ["run"] + sys.argv[1:]
runpy.run_module("torch_fdtd_string_tpu_torch.run", run_name="__main__")
"""


def test_the_package_runs_alone(tmp_path):
    alone = tmp_path / "alone"
    shutil.copytree(os.path.join(ROOT, "torch_fdtd_string_tpu_torch"),
                    alone / "torch_fdtd_string_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", STANDALONE, "experiment=nsynth-like", "proc.cpu=true",
         "task.num_samples=2", "task.batch_size=2", "task.length=0.01", "task.plot=false",
         "task.fuse_preprocess=false", "task.save_name=alone"],
        cwd=alone, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    run_dir = alone / "results" / "alone"
    items = sorted(p.name for p in run_dir.iterdir()
                   if (p / "simulation.npz").is_file() and (p / "output.wav").is_file())
    assert items, sorted(p.name for p in run_dir.iterdir())
    snapshot = run_dir / "codes" / "torch_fdtd_string_tpu_torch" / "configs"
    assert _files(str(snapshot)) == _files(trun.CONFIG_DIR)
