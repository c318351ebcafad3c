"""The port's scoring of a simulation run against the JAX package's:
``tasks/evaluate.py`` and ``tasks/summarize.py``.

One classic ``proc.cpu=true`` run of the port (two plucked strings of 50
ms) is written once; each package scores its own copy of it, so the
tables compare on the same wavs and parameters.  Tables are equal at 1e-6
(they are written to four decimals, so they read equal as written).
"""

import glob
import os
import sys
import shutil

import numpy as np
import pytest
import torch

from test_torch_simulate import BASE, CONFIG_DIR
from torch_fdtd_string_tpu.tasks import evaluate as jeval
from torch_fdtd_string_tpu.tasks import summarize as jsum
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.tasks import evaluate as teval
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.tasks import summarize as tsum
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

CLASSIC = [o for o in BASE if not o.startswith(("task.length", "task.chunk_length"))] + [
    "task.length=0.05", "task.chunk_length=0.05"]


@pytest.fixture(scope="module")
def sim_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    tsim.run(tcompose(CONFIG_DIR, CLASSIC), str(root / "sim"), "pluck", 1)
    assert len(glob.glob(str(root / "sim" / "0-*"))) == 2
    return root / "sim"


@pytest.fixture
def copies(sim_run, tmp_path):
    """One copy of the run for each package."""
    return tuple(str(shutil.copytree(sim_run, tmp_path / tag)) for tag in ("jax", "torch"))


def _table(path):
    """``(header, {row name: values})`` of a tab-separated score table."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = {}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = np.array([float(v) for v in parts[1:]])
    return header, rows


def _assert_tables_equal(jpath, tpath):
    jh, jr = _table(jpath)
    th, tr = _table(tpath)
    assert jh == th and jr.keys() == tr.keys() and tr
    for name in jr:
        np.testing.assert_allclose(tr[name], jr[name], rtol=0, atol=1e-6, err_msg=name)
    return tr


def _params_txt(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.split("\t") for line in f)}


def test_evaluate_matches_jax(copies):
    """``evaluation.txt`` and every item's ``string_params.txt`` as the JAX
    package writes them; the returned scores equal."""
    jd, td = copies
    js = jeval.evaluate(jd, plot=False)
    ts = teval.evaluate(td)
    assert [n for n, _ in js] == [n for n, _ in ts] == ["0-0", "0-1"]
    for (_, j), (_, t) in zip(js, ts):
        assert j.keys() == t.keys()
        np.testing.assert_allclose([t[k] for k in t], [j[k] for k in j], rtol=1e-9)
    rows = _assert_tables_equal(os.path.join(jd, "evaluation.txt"),
                                os.path.join(td, "evaluation.txt"))
    assert all(np.isfinite(v).all() for v in rows.values())
    for name in ("0-0", "0-1"):
        j = _params_txt(os.path.join(jd, name, "string_params.txt"))
        t = _params_txt(os.path.join(td, name, "string_params.txt"))
        assert list(j) == list(t)
        np.testing.assert_allclose(list(t.values()), list(j.values()), rtol=0, atol=1e-6)


@pytest.mark.parametrize("source", ["evaluation", "per-item"])
def test_summarize_matches_jax(copies, source):
    """``summary.txt`` from ``evaluation.txt``, or from the per-item files
    when there is none, as the JAX package writes it."""
    jd, td = copies
    jeval.evaluate(jd, plot=False)
    teval.evaluate(td)
    if source == "per-item":
        for d in copies:
            os.remove(os.path.join(d, "evaluation.txt"))
    jstats, tstats = jsum.summarize(jd), tsum.summarize(td)
    assert jstats.keys() == tstats.keys()
    for key in jstats:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-12)
    _assert_tables_equal(os.path.join(jd, "summary.txt"), os.path.join(td, "summary.txt"))


def test_summarize_mixed_headers(tmp_path, capsys):
    """A run mixing two per-item formats of one width keeps one header's
    rows and reports the drop, never merging positionally
    (tests/test_utils.py::test_summarize_mixed_headers), as the JAX
    package does on the same files."""
    old = ["id", "kappa", "alpha"]
    new = ["id", "kappa", "p_x"]
    for tag in ("jax", "torch"):
        for i, keys in enumerate([new, new, old]):
            d = tmp_path / tag / f"item{i}"
            d.mkdir(parents=True)
            with open(d / "string_params.txt", "w") as f:
                for j, k in enumerate(keys):
                    f.write(f"{k}\t{float(i + j):.4f}\n")
    assert tsum.summarize(str(tmp_path / "torch")) is not None
    out = capsys.readouterr().out
    assert "mixed column formats" in out and "dropping 1" in out
    jsum.summarize(str(tmp_path / "jax"))
    rows = _assert_tables_equal(str(tmp_path / "jax" / "summary.txt"),
                                str(tmp_path / "torch" / "summary.txt"))
    assert _table(str(tmp_path / "torch" / "summary.txt"))[0] == ["stat"] + new
    assert abs(rows["mean"][0] - 0.5) < 1e-6  # the mean of ids 0 and 1
    assert tsum.summarize(str(tmp_path / "empty")) is None


def test_plots_raise(copies, monkeypatch):
    """On a host without matplotlib ``plot=True`` raises an ImportError
    naming ``task.plot=false`` and writes nothing."""
    _, td = copies
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="task.plot=false"):
        teval.evaluate(td, plot=True)
    with pytest.raises(ImportError, match="task.plot=false"):
        teval.evaluate_dir(os.path.join(td, "0-0"), plot=True)
    assert not glob.glob(os.path.join(td, "*", "string_params.txt"))
    assert not os.path.exists(os.path.join(td, "evaluation.txt"))
    assert teval.evaluate_dir(os.path.join(td, "codes")) is None


def test_run_evaluate_and_summarize(copies, monkeypatch):
    """``experiment=evaluate`` and ``proc.summarize=true`` through
    ``run.main``, on a host without a card and without ``proc.cpu=true``:
    scoring is host numpy and chooses no device, as in the JAX package."""
    jd, td = copies
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trun.main(["experiment=evaluate", f"task.load_dir={td}"])
    trun.main(["proc.simulate=false", "proc.summarize=true", f"task.load_dir={td}"])
    jeval.evaluate(jd, plot=False)
    jsum.summarize(jd)
    for name in ("evaluation.txt", "summary.txt"):
        _assert_tables_equal(os.path.join(jd, name), os.path.join(td, name))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="task.plot=false"):
        trun.main(["experiment=evaluate", "task.plot=true", f"task.load_dir={td}"])
