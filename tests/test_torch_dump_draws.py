"""Run options of ``tasks/simulate.py`` the port used to ignore, against the
JAX package: ``task.dump_draws`` / ``task.dump_skipped`` (each string's
whole draw as ``draw-{dx}-{b}.npz``) and ``task.skip_nan=false`` on the
float64 engine route (a NaN string raises after its chunk).

The runs are float64, so both packages take their scan engine on the CPU.
"""

import glob
import os

import numpy as np
import pytest

from test_torch_simulate import CONFIG_DIR
from torch_fdtd_string_tpu.tasks import simulate as jsim
from torch_fdtd_string_tpu.utils.config import compose as jcompose
from torch_fdtd_string_tpu_torch.tasks import simulate as tsim
from torch_fdtd_string_tpu_torch.utils.config import compose as tcompose

RUN = ["experiment=nsynth-like", "task.num_samples=2", "task.batch_size=2",
       "task.length=0.003", "task.precision=double", "task.randomize_name=false",
       "proc.cpu=true", "task.fuse_preprocess=false", "task.plot=false",
       "task.plot_state=false"]


def _run(tmp_path, tag, compose, sim, overrides):
    d = tmp_path / tag
    d.mkdir()
    sim.run(compose(CONFIG_DIR, overrides), str(d), "random", 1)
    return str(d)


@pytest.mark.parametrize("option", ["dump_draws", "dump_skipped"])
def test_dumps_match_jax(tmp_path, option):
    """The same seed through both packages: the same draw files with equal
    arrays.  ``dump_draws`` dumps every string ("kept"); ``dump_skipped``
    the skipped ones, here both, skipped as silent under a silence gate
    above any level."""
    over = RUN + [f"task.{option}=true"]
    if option == "dump_skipped":
        over += ["task.skip_silence=true", "task.silence_threshold=1000"]
    else:
        over += ["task.skip_silence=false"]
    dirs = [_run(tmp_path, tag, compose, sim, over)
            for tag, compose, sim in (("jax", jcompose, jsim), ("torch", tcompose, tsim))]
    names = [sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "draw-*.npz")))
             for d in dirs]
    assert names[0] == names[1] == ["draw-0-0.npz", "draw-0-1.npz"]
    why = "kept" if option == "dump_draws" else "silent"
    for name in names[0]:
        jz, tz = (np.load(os.path.join(d, name)) for d in dirs)
        assert sorted(jz.files) == sorted(tz.files), name
        assert str(tz["why"]) == why
        for key in jz.files:
            assert jz[key].shape == tz[key].shape, (name, key)
            np.testing.assert_array_equal(jz[key], tz[key], err_msg=f"{name} {key}")


def test_no_dumps_by_default(tmp_path):
    d = _run(tmp_path, "torch", tcompose, tsim, RUN)
    assert not glob.glob(os.path.join(d, "draw-*.npz"))


def _diverging_draw():
    """The run's first batch (seed proc.seed) drawn by the port's sampler,
    which draws what the JAX package's does, string 1's initial
    displacement forced non-finite: ``process``'s arguments up to Nt."""
    args = tcompose(CONFIG_DIR, RUN)
    task = args.task
    kw = tsim.task_kwargs(task)
    theta = kw.pop("theta_t")
    string, bow, hammer, bm, hm, _ = tsim.draw_params(
        "random", task.sr, theta, task.length, task.batch_size, task.f0_inf,
        task.alpha_inf, task.lambda_c, precision="double",
        randomize_each=task.randomize_each, rng=np.random.default_rng(args.proc.seed),
        **kw)
    string.u0[1, 3] = np.nan
    consts = tsim.sim_consts(string, bm, hm, task.sr, theta, task.lambda_c)
    return string, bow, hammer, bm, hm, consts, int(task.length * task.sr)


def test_skip_nan_false_raises_on_the_engine_route():
    """``task.skip_nan=false``: a float64 batch whose string turns NaN
    raises after the chunk in both packages; with the default the NaN
    string comes back and the other stays finite."""
    import dataclasses

    import torch

    from torch_fdtd_string_tpu.core import params as jprm
    from torch_fdtd_string_tpu.core.engine import SimConsts as JSimConsts

    string, bow, hammer, bm, hm, consts, Nt = _diverging_draw()
    jargs = (jprm.StringState(**dataclasses.asdict(string)),
             jprm.BowState(**dataclasses.asdict(bow)),
             jprm.HammerState(**dataclasses.asdict(hammer)), bm, hm,
             JSimConsts(**{f: getattr(consts, f) for f in JSimConsts._fields
                           if f in consts._fields}), Nt)
    with pytest.raises(AssertionError):
        jsim.process(*jargs, 48, skip_nan=False)
    targs = (string, bow, hammer, bm, hm, consts, Nt, torch.device("cpu"))
    with pytest.raises(FloatingPointError, match=r"\[1\]"):
        tsim.process(*targs, chunk_size=48, skip_nan=False)
    uout = tsim.process(*targs, chunk_size=48)[0]
    assert np.isnan(uout[1]).all() and np.isfinite(uout[0]).all()
