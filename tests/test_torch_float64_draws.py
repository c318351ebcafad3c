"""The draws of ``chip_smoke.py --ab --float64``, on the CPU.

Each case runs once on its inputs and ulp-perturbed copies stacked along
the batch axis (``chip_smoke.stacked_draws``); that is a case's draws only
if no string depends on its batch neighbours, which the port's plain
version shows here bit for bit.  Then the whole decision on the plain
version: draw (a), ``chip_smoke.bench_inputs(4, 0.02, 7)`` over 256 steps,
two fixed sweeps as the first checkout and one as the later, a real loss
of accuracy, is refused.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

CPU = torch.device("cpu")


def _fields(out):
    return {key: x.numpy() for key, x in cs.named_fields(out)}


@pytest.mark.parametrize("which", ["unperturbed", "perturbed", "bucketed"])
def test_stacked_draws_equal_unstacked(which):
    """Draw (a) at B=4 over 64 steps, 4 draws stacked: block 0 of the
    stacked call equals the unstacked call bit for bit, and block 2 the
    call on ``ulp_perturbed(args, 2)``; the bucketed launch's plain version
    on the corpus recipe's first batch (B=48, several width groups), 2
    draws, each string in its own call's group (``stacked_groups``)."""
    if which == "bucketed":
        inputs, draws, block = cs.truncate(cs.nsynth_inputs(cs.CORPUS48, CPU), 64), 2, 0
        groups = sk.bucket_groups(*cs.host_bounds(inputs[0]), **{key: inputs[1][key] for key in (
            "k", "theta_t", "lambda_c", "M_t", "M_l")})
        assert len(groups) > 1
        B = inputs[0][0].shape[0]
        call = lambda a, kw, g: sk.string_chunked_bucketed(*a, groups=g, **kw)
        args, kw = cs.stacked_draws(inputs, draws)
        stacked = _fields(call(args, kw, cs.stacked_groups(groups, B, draws)))
        want = _fields(call(*inputs, groups))
    else:
        inputs, draws = cs.truncate(cs.bench_inputs(4, 0.02, 7, CPU), 64), 4
        B, block = 4, 0 if which == "unperturbed" else 2
        stacked = _fields(sk.string_chunked(*cs.stacked_draws(inputs, draws)[0], **inputs[1]))
        args = inputs[0] if block == 0 else cs.ulp_perturbed(inputs[0], block)
        want = _fields(sk.string_chunked(*args, **inputs[1]))
    assert sorted(stacked) == sorted(want)
    for key, x in want.items():
        assert cs.draw_block(key, stacked[key], block, B).shape == x.shape
        assert cs.draw_block(key, stacked[key], block, B).tobytes() == x.tobytes(), key


def test_fixed_one_sweep_refused_against_two():
    """The whole decision on the plain version, 4 draws of draw (a): the
    float64 run and the first checkout at two fixed sweeps, the later
    checkout at one.  Two sweeps against themselves are held; one sweep is
    refused on every field, further from float64 than two in the median
    draw by more than b (uout median 6.6e-2 against 9.9e-4, b 1.38e-3)."""
    draws = 4
    args, kw = cs.stacked_draws(cs.truncate(cs.bench_inputs(4, 0.02, 7, CPU), 256), draws)
    args64, kw64 = cs.cast_inputs((args, kw), torch.float64)
    run = lambda a, k, n: _fields(sk.string_chunked(*a, **dict(k, coupling_fixed=n)))
    x64, two, one = run(args64, kw64, 2), run(args, kw, 2), run(args, kw, 1)
    ok, rows, poisoned = cs.float64_case(x64, two, two, draws=draws)
    assert ok and poisoned == []
    assert all(r["shift"] == 0.0 and r["move"] < r["b"] for r in rows)
    ok, rows, poisoned = cs.float64_case(x64, two, one, draws=draws)
    assert not ok and poisoned == []
    assert [r["field"] for r in rows] == list(x64)
    for r in rows:
        assert not r["ok"] and r["shift"] > r["b"], r
        assert r["median"][1] - r["median"][0] > r["b"], r
        assert r["further"] == draws and r["within_b"][1] == 0, r


def test_ab_draws_saved_and_held(tmp_path, monkeypatch):
    """``--ab --float64``'s run of a case and its decision, on the CPU (the
    plain version in the kernel's place) at 3 draws over 32 steps, cases
    (a) and (k) (the bucketed launch): the first checkout's process writes
    the float64 fields and saves b, float64's move per perturbed draw and
    the per-string errors; a later checkout equal to it is held on every
    field of both cases."""
    monkeypatch.setattr(cs, "AB_DRAWS", 3)
    cases = tuple(c for c in cs.AB_CASES if c[0] in ("a", "k"))
    monkeypatch.setattr(cs, "AB_CASES", cases)
    saved = [{}, {}]
    for case in cases:
        tag, _, _, call = case
        args, kw, hb = cs.ab_case(cs, case, CPU, steps=32)
        out = {key: x.numpy() for key, x in cs.ab_fields(
            call, cs.ab_call(sk, call, args, kw, dict(host_bounds=hb))()).items()}
        for n in (0, 1):
            saved[n].update(cs.ab_draws(sk, case, (args, kw), hb, out, str(tmp_path), n == 0))
    paths = [str(tmp_path / f"ab{n}.npz") for n in (0, 1)]
    for path, arrays in zip(paths, saved):
        np.savez(path, **arrays)
    assert sorted(k for k in saved[0] if k.startswith("move/a/")) == [
        f"move/a/{key}" for key in sorted(out)]
    assert saved[0]["move/a/uout"].shape == (2,) and saved[0]["e/k/state_u"].shape == (72,)
    assert not any(k.startswith(("b/", "move/", "nan64/")) for k in saved[1])
    assert cs.ab_float64(["first", "later"], paths)
