"""Parameter draws: one seed gives bit-identical bundles in both packages."""

import dataclasses
import os

import numpy as np
import pytest

from torch_fdtd_string_tpu.core import params as jprm
from torch_fdtd_string_tpu_torch.core import params as tprm
from torch_fdtd_string_tpu_torch.tasks.simulate import task_kwargs
from torch_fdtd_string_tpu_torch.utils.config import compose

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "torch_fdtd_string_tpu", "configs",
)


def _draw(prm, model_name, precision, seed=1234, B=6, length=0.05):
    args = compose(CONFIG_DIR, ["experiment=nsynth-like"])
    task = args.task
    kw = task_kwargs(task)
    sr = task.sr
    k = 1.0 / sr
    rng = np.random.default_rng(seed)
    bow_mask, hammer_mask = prm.get_masks(rng, model_name, B)
    pluck_mask = ~(bow_mask | hammer_mask)
    string = prm.sample_string(
        rng, k=k, theta_t=kw["theta_t"], lambda_c=task.lambda_c, sr=sr,
        length=length, f0_inf=task.f0_inf, alpha_inf=task.alpha_inf,
        batch_size=B, precision=precision,
        pluck_batch=True if model_name == "pluck" else None,
        pluck_mask=pluck_mask, hammer_mask=hammer_mask,
        randomize_each=task.randomize_each, **kw["string_kwargs"],
    )
    bow = prm.sample_bow(rng, sr=sr, length=length, batch_size=B,
                         precision=precision, **kw["bow_kwargs"])
    hammer = prm.sample_hammer(rng, sr=sr, length=length, batch_size=B,
                               precision=precision, k=k, **kw["hammer_kwargs"])
    return (bow_mask, hammer_mask), string, bow, hammer


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("model_name", ["pluck", "random"])
@pytest.mark.parametrize("precision", ["single", "double"])
def test_draws_bit_identical(model_name, precision):
    jmasks, *jbundles = _draw(jprm, model_name, precision)
    tmasks, *tbundles = _draw(tprm, model_name, precision)
    for a, b in zip(jmasks, tmasks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jbundles, tbundles):
        _assert_same(a, b)


def test_state_from_numpy_round_trip():
    _, *jb = _draw(jprm, "random", "single")
    _, *tb = _draw(tprm, "random", "single")
    from_jax = tprm.state_from_numpy(*jb)
    again = tprm.state_from_numpy(*from_jax)
    for cls, a, b, c in zip(
        (tprm.StringState, tprm.BowState, tprm.HammerState), from_jax, again, tb
    ):
        assert type(a) is cls and type(b) is cls
        _assert_same(a, c)
        _assert_same(b, c)
    # copies, not views of the source arrays
    from_jax[0].u0[:] = 0.0
    assert np.abs(jb[0].u0).max() > 0.0
    assert tprm.state_from_numpy(None, None, None) == (None, None, None)
