"""The port's figures (``utils/plot.py``, ``tasks/callbacks.py``, the
analytic fields of ``core/analytic.py``) against the JAX package's.

Every drawing function runs in both packages on the same seeded inputs,
each into its own directory: the files written carry the same names, and
the arrays handed to matplotlib (``Axes.plot``, ``imshow``, ``scatter``,
``pcolormesh``, ``semilogy``, ``fill_between``, captured by
monkeypatching) are equal at 1e-9 of scale in float64.  Then each entry
point that draws, with ``task.plot=true``, writes the files the JAX
package writes: ``experiment=linear-string`` at a millisecond, the
evaluation of a two-item run, a one-item summary, the preset tool, the
time figure (the DMSP trainer's are in
``tests/test_torch_dmsp_train.py``).  Without
matplotlib each figure option raises an ImportError naming the option
(``tests/test_torch_simulate.py``, ``test_torch_evaluate.py``,
``test_torch_presets.py``, ``test_torch_dmsp_*.py`` and below).
"""

import glob
import json
import os
import sys

import matplotlib.axes
import numpy as np
import pytest

from test_torch_evaluate import CLASSIC
from test_torch_presets import synthetic_recording
from test_torch_simulate import CONFIG_DIR
from torch_fdtd_string_tpu.core import analytic as janalytic
from torch_fdtd_string_tpu.tasks import callbacks as jcallbacks
from torch_fdtd_string_tpu.tasks import evaluate as jeval
from torch_fdtd_string_tpu.tasks import preprocess_data as jpre
from torch_fdtd_string_tpu.tasks import summarize as jsum
from torch_fdtd_string_tpu.utils import plot as jplot
from torch_fdtd_string_tpu_torch import run as trun
from torch_fdtd_string_tpu_torch.core import analytic as tanalytic
from torch_fdtd_string_tpu_torch.tasks import callbacks as tcallbacks
from torch_fdtd_string_tpu_torch.tasks import evaluate as teval
from torch_fdtd_string_tpu_torch.tasks import preprocess_data as tpre
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.tasks import summarize as tsum
from torch_fdtd_string_tpu_torch.tasks import time_experiment as tte
from torch_fdtd_string_tpu_torch.utils import plot as tplot
from torch_fdtd_string_tpu_torch.utils import wav as twav
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

SR = 48000
BOUND = 1e-9  # of each drawn array's scale
DRAWS = ("plot", "imshow", "scatter", "pcolormesh", "semilogy", "fill_between")


@pytest.fixture
def capture(monkeypatch):
    """``capture(fn)``: run ``fn`` and return the numeric arrays it handed
    to matplotlib's drawing calls, in order."""
    drawn = []

    def patched(name):
        real = getattr(matplotlib.axes.Axes, name)

        def draw(self, *args, **kwargs):
            for a in list(args) + [kwargs.get("c")]:
                if a is None or isinstance(a, str):
                    continue
                arr = np.asarray(a)
                if arr.dtype.kind in "fiub":
                    drawn.append(arr.astype(np.float64))
            return real(self, *args, **kwargs)

        return draw

    for name in DRAWS:
        monkeypatch.setattr(matplotlib.axes.Axes, name, patched(name))

    def run(fn):
        drawn.clear()
        fn()
        return list(drawn)

    return run


def files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                             recursive=True)
                  if os.path.isfile(p))


def assert_same_drawing(want, got):
    assert len(want) == len(got) and want
    for a, b in zip(want, got):
        assert a.shape == b.shape
        scale = max(np.nanmax(np.abs(a)) if a.size else 0.0, 1e-300)
        same_nan = np.isnan(a) == np.isnan(b)
        assert same_nan.all()
        assert np.nan_to_num(np.abs(a - b)).max(initial=0.0) <= BOUND * scale


def both(capture, tmp_path, call):
    """``call(module, out_dir)`` with the JAX and the port's ``utils/plot``
    (or any module pair ``call`` picks by the flag): the same files and the
    same drawn arrays."""
    out = {}
    for tag, mod in (("jax", jplot), ("torch", tplot)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        out[tag] = (capture(lambda: call(mod, d)), files(d))
    assert out["jax"][1] == out["torch"][1] and out["torch"][1]
    assert_same_drawing(out["jax"][0], out["torch"][0])
    return out["torch"][1]


# ---- the analytic fields -------------------------------------------------------------

def test_analytic_fields_match_jax():
    rng = np.random.default_rng(0)
    u0 = np.interp(np.arange(48), [0, 17, 47], [0, 0.01, 0])
    z0 = 0.1 * u0 * rng.uniform(0.5, 1.5)
    f0 = 110.0 * (1 + 0.01 * np.linspace(0, 1, 300))
    for f in (f0, 220.0):
        want = janalytic.lossless_nonstiff_string(u0, f, 300, 48, SR)
        got = tanalytic.lossless_nonstiff_string(u0, f, 300, 48, SR)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    want = janalytic.nonlinear_wave_solution(u0, z0, f0, 3.5, 300, 48, SR)
    got = tanalytic.nonlinear_wave_solution(u0, z0, f0, 3.5, 300, 48, SR)
    for a, b in zip(want, got):
        assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()


# ---- each drawing function -----------------------------------------------------------

def _wave(n=9600, f=220.0, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return np.sin(2 * np.pi * f * t) * np.exp(-3 * t) + 1e-3 * rng.standard_normal(n)


def _item(seed=1, Nt=960, Nx=40):
    """A simulated item's arrays and parameter lists, seeded."""
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((Nt, Nx)) * 1e-3
    f0 = 200 + rng.random(Nt)
    string = [0.02, 3.0, state[:1], state[1:2], 0.01, f0, 0.3, np.array([[1e3, 10], [1e2, 5]]),
              f0]
    bow = [np.full(Nt, 0.2), np.full(Nt, 0.1), np.linspace(0, 50, Nt), 3.0, 0.4, 0.05]
    hammer = [0.3, 1.0, np.zeros(Nt), 1000.0, 5.0, 2.5]
    outs = [_wave(Nt, seed=seed), 1e-3 * _wave(Nt, 440.0, seed + 1), rng.standard_normal(Nt - 2),
            rng.standard_normal(Nt), rng.standard_normal(Nt)]
    return state, string, bow, hammer, outs


FIGURES = {
    "rainbowgram": lambda m, d: m.rainbowgram(f"{d}/a.pdf", _wave(), SR,
                                              f0_input=np.full(40, 220.0), colorbar=True),
    "rainbowgram_hsv": lambda m, d: m.rainbowgram_hsv(
        f"{d}/a.png", _wave(30000), SR, f0_input=np.full(40, 220.0),
        f0_estimate=np.full(30, 221.0), modes=[np.full(20, 440.0)]),
    "phase_diagram": lambda m, d: m.phase_diagram(f"{d}/a.pdf", _wave(), SR, tau=2),
    "simulation_plots": lambda m, d: m.simulation_plots(d, _wave(), 0.01 * _wave(seed=3),
                                                        np.full(10, 220.0), SR),
    "simulation_data": lambda m, d: m.simulation_data(
        d, *_item()[4], _item()[0], 0.1 * _item()[0], string_params=_item()[1],
        bow_params=_item()[2], hammer_params=_item()[3], sr=SR),
    "state_specs": lambda m, d: m.state_specs(
        f"{d}/s.pdf", *(np.random.default_rng(k).standard_normal((1600, 12)) for k in range(3))),
    "est_tar_specs": lambda m, d: m.est_tar_specs(
        d, np.stack([_wave(4096, seed=k) for k in range(2)]),
        np.stack([_wave(4096, seed=k + 5) for k in range(2)]),
        np.stack([_wave(4096, seed=k + 9) for k in range(2)]), SR),
    "detune_scatter": lambda m, d: m.detune_scatter(
        f"{d}/s.pdf", {"a": np.arange(5.0), "b": np.arange(5.0) ** 2}, np.linspace(0.01, 0.03, 5),
        alpha=np.arange(5.0), p_x=np.linspace(0, 1, 5), p_a=np.ones(5)),
    "state_video": lambda m, d: m.state_video(d, np.random.default_rng(2).standard_normal(
        (50, 16)), SR, trim_front=True, max_frames=8),
    "time_scaling_figure": lambda m, d: m.time_scaling_figure(f"{d}/t.pdf", {
        "batch size": {"kernel": [(4, 1.0), (16, 1.5), (64, 3.0)], "engine": [(4, 9.0)]},
        "length (s)": {"kernel": [(0.25, 0.3), (1.0, 1.0)]}}),
    "scatter_kappa": lambda m, d: m.scatter_kappa(
        f"{d}/k.pdf", np.arange(30.0) % 7, np.linspace(0, 2, 30),
        np.random.default_rng(3).uniform(0.01, 0.03, 30), alpha=np.arange(30.0)),
    "rde_specs": lambda m, d: m.rde_specs(
        d, [1.0, 2.0], {"wav": [_wave(4800, 220.0), _wave(4800, 440.0)],
                        "state": [np.random.default_rng(k).standard_normal((2000, 6, 2))
                                  for k in range(2)]},
        {"wav": [_wave(4800, 221.0), _wave(4800, 442.0)],
         "state": [np.random.default_rng(k + 4).standard_normal((2000, 6, 2))
                   for k in range(2)]}, SR),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_matches_jax(name, capture, tmp_path):
    both(capture, tmp_path, FIGURES[name])


@pytest.mark.parametrize("name", ["plot_results", "plot_state_video"])
def test_callback_matches_jax(name, capture, tmp_path):
    rng = np.random.default_rng(5)
    if name == "plot_results":
        outputs = {"preds": rng.standard_normal((3, 4096)), "target": rng.standard_normal(
            (3, 4096)), "analytic": rng.standard_normal((3, 4096))}
        args = ("valid", outputs, SR)
        kw = dict(n_items=1, step=7)
    else:  # 8 frames; the per-stream rainbowgrams start at 2,048 samples
        args = tuple(rng.standard_normal((8, 8)) for _ in range(3)) + (SR,)
        kw = dict(name="0-1")
    names = both(capture, tmp_path, lambda m, d: getattr(
        tcallbacks if m is tplot else jcallbacks, name)(d, *args, **kw))
    assert ("plots/valid_7/item0_specs.png" in names if name == "plot_results"
            else {"0-1.pdf", "0-1.npz", "0-1-fdtd.wav", "_frames/00007.png"} <= set(names))


# ---- the entry points ----------------------------------------------------------------

def test_linear_string_draws_as_jax(capture, tmp_path):
    """``experiment=linear-string`` as configured (``task.plot=true``,
    ``plot_state=true``) at 12 steps on the CPU (the silence skip off: so
    short a run is silent): the item's figures and state video are what
    the JAX package's drawing of the same item writes and draws."""
    drawn = capture(lambda: trun.main([
        "experiment=linear-string", "proc.cpu=true", "task.length=0.00025",
        "task.skip_silence=false",
        f"task.root_dir={tmp_path}", "task.save_name=port"]))
    item = str(tmp_path / "port" / "0-0")
    sim = np.load(os.path.join(item, "simulation.npz"), allow_pickle=True)
    params = [np.load(os.path.join(item, f"{k}_params.npz")) for k in ("string", "bow", "hammer")]
    names = [("kappa", "alpha", "u0", "v0", "p_a", "f0", "pos", "T60", "target_f0"),
             ("x_B", "v_B", "F_B", "phi_0", "phi_1", "wid_B"),
             ("x_H", "v_H", "u_H", "w_H", "M_r", "alpha")]
    lists = [[p[k] for k in ks] for p, ks in zip(params, names)]
    jdir = str(tmp_path / "jax")

    def jax_draws():
        jplot.simulation_plots(jdir, sim["uout"], sim["zout"], lists[0][8], SR)
        jplot.simulation_data(jdir, sim["uout"], sim["zout"], sim["v_r_out"], sim["F_H_out"],
                              sim["u_H_out"], sim["state_u"], sim["state_z"],
                              string_params=lists[0], bow_params=lists[1],
                              hammer_params=lists[2], sr=SR)
        jplot.state_video(jdir, sim["state_u"], SR)

    want = capture(jax_draws)
    drawn_files = set(files(item))
    assert set(files(jdir)) <= drawn_files
    assert {"spec.pdf", "f0.pdf", "phs.pdf", "string.png", "bow-velforce.pdf",
            "string_state.npz", "_frames/00011.png"} <= drawn_files
    assert_same_drawing(want, drawn)


def test_evaluate_two_items_draws_as_jax(capture, tmp_path):
    """``tasks/evaluate.py`` with ``plot`` on a two-item run (the two files
    it reads of each classic item: a decaying 0.1 s tone and its
    parameters): the items' rainbowgrams and the run's detune scatters."""
    out = {}
    for tag, mod in (("jax", jeval), ("torch", teval)):
        d = str(tmp_path / tag)
        for i, f0 in enumerate((196.0, 330.0)):
            item = os.path.join(d, f"0-{i}")
            os.makedirs(item)
            twav.write(os.path.join(item, "output-u.wav"), 0.5 * _wave(4800, f0 * 1.01), SR)
            np.savez(os.path.join(item, "string_params.npz"), f0=np.full(4800, f0),
                     target_f0=np.full(4800, f0 * 1.01), kappa=np.array([0.02]),
                     alpha=np.array([3.0]), p_a=np.array([0.01]),
                     u0=np.interp(np.arange(64), [0, 20 + i, 63], [0, 0.01, 0])[None])
        out[tag] = (capture(lambda: mod.evaluate(d, plot=True)), files(d))
    assert out["jax"][1] == out["torch"][1]
    assert {"detune_scatter.pdf", "detune_kappa.pdf", "0-1/eval_f0_hsv.png"} <= set(
        out["torch"][1])
    assert_same_drawing(*(out[k][0] for k in ("jax", "torch")))


def test_summarize_and_presets_draw_as_jax(capture, tmp_path):
    """A one-item summary (best effort in both packages) and the preset
    tool's ``spec.pdf``."""
    header = ["f0_estimate", "f0_target_mean", "abs_diff_input", "abs_diff_target", "kappa",
              "alpha", "p_a", "p_x"]
    out = {}
    for tag, summ, pre in (("jax", jsum, jpre), ("torch", tsum, tpre)):
        d = tmp_path / tag
        os.makedirs(d)
        with open(d / "evaluation.txt", "w") as f:
            f.write("item\t" + "\t".join(header) + "\n0-0\t" + "\t".join(
                f"{v:.4f}" for v in (220.5, 220.0, 0.7, 0.5, 0.02, 3.0, 0.01, 0.3)) + "\n")
        synthetic_recording(str(d / "rec"), length=0.3)
        out[tag] = (capture(lambda: (summ.summarize(str(d)), pre.process(str(d), "rec"))),
                    files(str(d)))
    assert out["jax"][1] == out["torch"][1]
    assert {"summary_f0.pdf", "summary_detune.pdf", "rec/spec.pdf"} <= set(out["torch"][1])
    assert_same_drawing(*(out[k][0] for k in ("jax", "torch")))


def test_time_sweep_draws_its_figure(tmp_path, monkeypatch):
    """``run_sweep`` draws ``time_experiment.pdf`` after the JSON, as the
    JAX package does (its points timed by a stand-in here; the real sweep
    is ``tests/test_torch_time_experiment.py``); ``plot=False`` leaves it
    out, and without matplotlib the default raises before any point is
    timed."""
    monkeypatch.setattr(tte, "build_workload", lambda **kw: (kw,))
    monkeypatch.setattr(tte, "_time_kernel", lambda wl, device, reps: 1e-3 * wl["B"])
    kw = dict(batches=(2, 4), lengths=(0.011,), device="cpu", with_engine=False)
    tte.run_sweep(str(tmp_path / "a"), **kw)
    assert sorted(os.listdir(tmp_path / "a")) == ["time_experiment.json", "time_experiment.pdf"]
    tte.run_sweep(str(tmp_path / "b"), plot=False, **kw)
    assert os.listdir(tmp_path / "b") == ["time_experiment.json"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot=false"):
        tte.run_sweep(str(tmp_path / "c"), **kw)
    assert not os.path.exists(tmp_path / "c")


def test_plot_state_alone_needs_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = tcompose(CONFIG_DIR, CLASSIC + ["task.plot_state=true"])
    with pytest.raises(ImportError, match="task.plot_state=false"):
        tsim.run(args, str(tmp_path), "pluck", 1)
    assert json.loads(json.dumps(os.listdir(tmp_path))) == []

