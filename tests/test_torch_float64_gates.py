"""The float32 string step held to its float64 plain version, and the
``chip_smoke.py --ab --float64`` comparator.

Draw (a) is ``chip_smoke.bench_inputs(4, 0.02, 7)``, the bench workload at
seed 7, over 256 steps; the JAX test of the fixed sweep schedule
(tests/test_pallas_kernel.py:219-246) draws the same workload at seed 11.
On the CPU ``string_chunked`` runs the plain version; its float64 run is the
same call on the float32 inputs cast to float64.  chip_smoke.py phase 3 (t)
holds the card's kernel to that float64 run by the same functions, over
draw (a)'s 17 stacked draws (``float64_hold``).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

CPU = torch.device("cpu")


class _Runs(dict):
    """The adaptive, one- and two-sweep results, float32 and float64, of
    draw (a) on its AB_DRAWS stacked draws (``chip_smoke.stacked_draws``:
    the inputs, then u1 and u2 one float32 ulp up at seeds 1-16), as phase
    3 (t) runs them, and of seed 11: ``runs[seed, dtype, coupling_fixed]``
    is ``(uout, zout, aux)``, computed on first use, on one CPU thread (the
    B=68 stack runs several times faster there than on the default pool
    beside the other test workers)."""

    def __missing__(self, key):
        seed, dtype, n = key
        inputs = cs.truncate(cs.bench_inputs(4, 0.02, seed, CPU), 256)
        if seed == 7:
            inputs = cs.stacked_draws(inputs, cs.AB_DRAWS)
        args, kw = cs.cast_inputs(inputs, dtype)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            self[key] = sk.string_chunked(*args, **dict(kw, coupling_fixed=n))
        finally:
            torch.set_num_threads(threads)
        return self[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _draw0(out):
    """The unperturbed draw's rows of a stacked result: the call on draw
    (a) itself, bit for bit (tests/test_torch_float64_draws.py)."""
    return cs.take_rows(out, slice(0, 4))


@pytest.mark.parametrize("fixed", [0, 2], ids=["adaptive", "fixed2"])
def test_float32_within_f32_bounds_of_float64(runs, fixed):
    """Draw (a) over its 17 stacked draws, as phase 3 (t) holds the card:
    in the median draw the float32 final state within STATE_ATOL (1.2e-5)
    and STATE_REL (6e-4) of the float64 scale, uout within READOUT_REL
    (2e-4) of it, the bounds of tests/test_pallas_kernel.py:53-58
    (``float64_hold``).  Medians on the CPU: adaptive 3.22e-6 / 2.46e-4 of
    scale and uout 1.55e-4 (within 2e-4 on 13 of 17 draws); fixed-2
    3.14e-6 / 2.39e-4 and uout 1.45e-4 (16 of 17, draw 16 at 2.15e-4).
    The unperturbed draw alone reads fixed-2 uout 1.955e-4."""
    hold = cs.float64_hold(cs.draw_distances(runs[7, torch.float32, fixed],
                                             runs[7, torch.float64, fixed], cs.AB_DRAWS))
    assert hold["values"].shape == (cs.AB_DRAWS, 3)
    assert hold["ok"], (hold["median"], hold["within"])


def test_one_sweep_refused_by_float64_hold(runs):
    """The hold still refuses a real loss of accuracy: on the same 17
    draws the float32 one-sweep result against the float64 two-sweep run
    fails it, its median draw past the bound in the final state and uout
    and no draw within it in uout (tests/test_torch_float64_draws.py
    reads one sweep at uout median 6.6e-2 against b 1.38e-3)."""
    hold = cs.float64_hold(cs.draw_distances(runs[7, torch.float32, 1],
                                             runs[7, torch.float64, 2], cs.AB_DRAWS))
    assert not hold["ok"]
    assert hold["median"][1] > cs.STATE_REL and hold["median"][2] > cs.READOUT_REL, hold
    assert hold["within"][2] == 0, hold["within"]


# float64_hold's synthetic cases: the final state's errors per draw and
# its scale, uout's errors as shares of its scale, and the verdict; 17 draws
HOLD_CASES = {
    # 16 draws at the fixed-2 median, draw 16 at 2.15e-4 of scale (run F2)
    "one_draw_past": ([3e-6] * 17, 0.02, [1.45e-4] * 16 + [2.15e-4], True),
    # 9 of 17 draws past 2e-4: the median is
    "uout_median_past": ([3e-6] * 17, 0.02, [1.45e-4] * 8 + [2.05e-4] * 9, False),
    # the state 1.3e-5 from float64 on 9 draws: past STATE_ATOL, 2.6e-4 of
    # its scale
    "state_atol_past": ([3e-6] * 8 + [1.3e-5] * 9, 0.05, [1.45e-4] * 17, False),
    # the state 1e-5 from float64 on 9 draws: within STATE_ATOL, 1e-3 of
    # its scale
    "state_rel_past": ([3e-6] * 8 + [1e-5] * 9, 0.01, [1.45e-4] * 17, False),
}


@pytest.mark.parametrize("case", list(HOLD_CASES))
def test_float64_hold(case):
    """``float64_hold`` on synthetic draws: one draw at 2.15e-4 of scale
    with the median under 2e-4 is held (on 16 of 17); a uout median past
    2e-4 fails; a final state whose median draw lies past STATE_ATOL, or
    past STATE_REL of its scale, fails on that quantity alone."""
    s_err, s_scale, u_rel, want = HOLD_CASES[case]
    rows = [(s, s_scale, u, 1.0) for s, u in zip(s_err, u_rel)]
    hold = cs.float64_hold(rows)
    assert hold["ok"] == want, hold["median"]
    past = hold["median"] > np.array([b for _, b in cs.HOLD_QUANTITIES])
    assert list(past) == [case == "state_atol_past", case == "state_rel_past",
                          case == "uout_median_past"]
    if case == "one_draw_past":
        assert list(hold["within"]) == [17, 17, 16]
        assert hold["values"][16, 2] == pytest.approx(2.15e-4)


def test_exact_fixed_gap_on_seed_7_is_over_the_twin_bound(runs):
    """Why phase 3 (t) holds two fixed sweeps against the adaptive schedule
    on seed 11 and not on draw (a): in float64 the final states of seed 7
    part by 2.170e-4 of scale, over the 2e-4 bound, so no rounding of a
    float32 kernel is held to anything there; on seed 11, the JAX test's
    draw, float64 reads 1.589e-5 and float32 3.880e-5."""
    gap7 = cs.fixed_gap(_draw0(runs[7, torch.float64, 0]), _draw0(runs[7, torch.float64, 2]))
    assert gap7[0] > cs.FIXED_STATE_REL, gap7
    assert gap7[2] == 4
    for dtype in (torch.float64, torch.float32):
        state, uout, n = cs.fixed_gap(runs[11, dtype, 0], runs[11, dtype, 2])
        assert n == 4
        assert state < cs.FIXED_STATE_REL and uout < cs.FIXED_UOUT_REL, (dtype, state, uout)


def _case(rng, B=4, T=16, M=8, excited=False):
    """A synthetic case's float64 fields: uout, zout, state and carry."""
    f = {"uout": rng.standard_normal((B, T)), "zout": 1e-3 * rng.standard_normal((B, T)),
         "state_u": rng.standard_normal((T, B, M)), "state_z": rng.standard_normal((T, B, M))}
    for key in ("u1", "u2", "z1", "z2"):
        f[key] = 1e-3 * rng.standard_normal((B, M))
    if excited:
        f.update(v_r=rng.standard_normal((B, T)), F_H=rng.standard_normal((B, T)),
                 u_H=rng.standard_normal((B, T)))
    return f


def _off(fields, by, rng):
    """The fields, each moved by ``by[key]`` times a random sign, as float32."""
    return {key: (x + by.get(key, 0.0) * rng.choice([-1.0, 1.0], x.shape)).astype(np.float32)
            for key, x in fields.items()}


def _stack(blocks):
    """Draws' fields stacked along each field's batch axis, as
    ``chip_smoke.stacked_draws`` stacks a case's draws."""
    return {key: np.concatenate([b[key] for b in blocks],
                                axis=1 if key in ("state_u", "state_z") else 0)
            for key in blocks[0]}


def _bound(key, x64, gmres=False):
    return cs.field_bounds(x64, gmres)[key]


# the draw rule's cases: 9 draws; per draw, how far the first checkout lies
# from float64 in units of b.  "rounding_differs": the later checkout has
# the first's draws 0 and 4 swapped, the unperturbed draw's 0.3 b -> 2.0 b
# as on case (t)
DRAWS = 9
FIRST_BY = [0.3, 0.5, 0.4, 0.6, 2.0, 0.45, 0.35, 0.55, 1.6]
SWAPPED = [4, 1, 2, 3, 0, 5, 6, 7, 8]
# "spread_past_b": every draw far past b, as case (b)'s z fields on the
# card; the later checkout's draws 0 and 1 rise above the median, whose
# unpaired value then moves by 40 b
SPREAD_BY = [40.0, 60.0, 80.0, 100.0, 120.0, 140.0, 160.0, 180.0, 200.0]
SPREAD_LATER_BY = [190.0, 210.0] + SPREAD_BY[2:]

GATE_CASES = ["same_distance", "within_b", "past_b_uout", "past_b_carry_u1",
              "past_b_carry_z2", "within_move", "past_move", "one_more_poisoned",
              "one_fewer_poisoned", "zout_floor", "force", "rounding_differs",
              "shift_2b", "minority_past_b", "majority_past_b", "poisoned_in_perturbed_draw",
              "poisoned_as_float64", "spread_past_b"]
DRAW_CASES = GATE_CASES[-7:]


def _draw_case(case, x0):
    """A draw-rule case on DRAWS copies of the fields ``x0`` (float64 does
    not move): ``(x64, first, later, want)``."""
    bound = cs.field_bounds(x0)
    by = lambda m: {key: m * b for key, b in bound.items()}
    x64 = _stack([x0] * DRAWS)
    first_by = SPREAD_BY if case == "spread_past_b" else FIRST_BY
    first = _stack([_off(x0, by(m), np.random.default_rng(10 + i))
                    for i, m in enumerate(first_by)])
    if case == "spread_past_b":
        later = _stack([_off(x0, by(m), np.random.default_rng(10 + i))
                        for i, m in enumerate(SPREAD_LATER_BY)])
        return x64, first, later, True
    if case == "rounding_differs":
        later = _stack([_off(x0, by(FIRST_BY[j]), np.random.default_rng(10 + j))
                        for j in SWAPPED])
        return x64, first, later, True
    later = dict(first, uout=first["uout"].copy())
    B = x0["uout"].shape[0]
    shifted = {"shift_2b": range(DRAWS), "minority_past_b": (1, 4, 7),
               "majority_past_b": (1, 2, 4, 6, 7)}.get(case, ())
    for i in shifted:
        step = 2.0 if case == "shift_2b" else 3.0
        later["uout"][i * B:(i + 1) * B] += np.float32(step * bound["uout"])
    if case.startswith("poisoned"):
        later["uout"][3 * B + 1, 9:] = np.nan
    if case == "poisoned_as_float64":
        x64["uout"][3 * B + 1, 11:] = np.nan
    return x64, first, later, case in ("minority_past_b", "poisoned_as_float64")


@pytest.mark.parametrize("case", GATE_CASES)
def test_float64_comparator(case):
    """``float64_case`` on synthetic arrays.  One draw: a later checkout as
    far from float64 as the first passes, and one within b of the first's
    distance; one further by more than b in uout or in a carry field of
    (u)'s (u1, u2, z1, z2, held as state) fails, unless float64 itself
    moves by more than that under a one-ulp change of the inputs (its
    second draw), and then one further by more than that move fails; one
    more poisoned string fails, one fewer passes and is listed; an excited
    GMRES case's zout bound follows ZOUT_FLOOR of uout's scale; F_H's is
    FORCE_REL of max(scale, 1).  Over 9 draws the median decides: the same
    distances in another order pass although the unperturbed draw alone
    fails (0.3 b -> 2.0 b); 2 b further on every draw fails; 3 b further on
    3 draws passes (the median holds), on 5 fails; a string poisoned in one
    perturbed draw fails, unless float64 poisons it too; where every draw
    lies far past b, two draws rising past the median pass, though the
    unpaired median moves by 40 b."""
    rng = np.random.default_rng(3)
    x0 = x64 = _case(rng, excited=case in ("zout_floor", "force"))
    gmres, draws, want = case == "zout_floor", 1, True
    if case == "zout_floor":
        x64["zout"] *= 1e-9  # below ZOUT_FLOOR of uout
    elif case == "force":
        x64["F_H"] *= 1e-3
    if case in DRAW_CASES:
        x64, first, later, want = _draw_case(case, x0)
        draws = DRAWS
        if case == "rounding_differs":  # the unperturbed draw alone fails
            block0 = lambda d: {k: cs.draw_block(k, x, 0, 4) for k, x in d.items()}
            assert not cs.float64_case(block0(x64), block0(first), block0(later))[0]
    else:
        first_by = {key: 0.5 * _bound(key, x64, gmres) for key in x64}
        first = _off(x64, first_by, np.random.default_rng(4))
        later = first
    if case == "within_b":
        later = _off(x64, {key: 1.4 * v for key, v in first_by.items()},
                     np.random.default_rng(5))
    elif case.startswith("past_b"):
        key = {"past_b_uout": "uout", "past_b_carry_u1": "u1", "past_b_carry_z2": "z2"}[case]
        later = dict(first)
        later[key] = first[key] + np.float32(2.5 * _bound(key, x64))
        want = False
    elif case in ("within_move", "past_move"):
        # float64's second draw moves 3 b in uout; the later checkout is
        # 2.5 b or 3.5 b further on both draws
        b = _bound("uout", x64)
        moved = dict(x64, uout=x64["uout"] + 3.0 * b)
        first = _stack([first, _off(moved, first_by, np.random.default_rng(6))])
        x64, draws = _stack([x64, moved]), 2
        moves = cs.float64_moves(x64, draws)
        assert moves["uout"] == pytest.approx([3.0 * b]) and moves["zout"] == [0.0]
        by = 2.5 if case == "within_move" else 3.5
        later = dict(first, uout=first["uout"] + np.float32(by * b))
        want = case == "within_move"
    elif case in ("one_more_poisoned", "one_fewer_poisoned"):
        first["uout"][0, 5] = np.nan
        later = dict(first, uout=first["uout"].copy())
        (later if case == "one_more_poisoned" else first)["uout"][2, 7:] = np.nan
        want = case == "one_fewer_poisoned"
    elif case == "zout_floor":
        b = _bound("zout", x64, gmres=True)
        assert b == pytest.approx(cs.ZOUT_REL * cs.ZOUT_FLOOR * np.abs(x64["uout"]).max())
        assert _bound("zout", x64) < 1e-3 * b  # without the floor: its own scale
        later = dict(first, zout=(x64["zout"] + 0.9 * b).astype(np.float32))
    elif case == "force":
        b = _bound("F_H", x64)
        assert b == pytest.approx(cs.FORCE_REL)
        later = dict(first, F_H=(x64["F_H"] + 1.4 * b).astype(np.float32))
    ok, rows, poisoned = cs.float64_case(x64, first, later, gmres, draws)
    assert ok == want, (case, rows)
    assert [r["field"] for r in rows] == list(x64)
    assert all(r["n"] == draws for r in rows)
    if case.endswith("poisoned"):
        assert poisoned == [(0, 2, case == "one_fewer_poisoned", case == "one_more_poisoned",
                             True)]
    elif case in ("poisoned_in_perturbed_draw", "poisoned_as_float64"):
        assert poisoned == [(3, 1, False, True, case == "poisoned_in_perturbed_draw")]
        assert all(r["ok"] for r in rows)  # the poison rule alone decides
    else:
        assert poisoned == []
    if case == "same_distance":
        assert all(r["e0"][0] == r["e0"][1] and r["move"] == 0.0 for r in rows)
        rows_b = {r["field"]: r["b"] for r in rows}
        for key in cs.STATE_FIELDS:
            scale = np.abs(x64[key]).max()
            assert rows_b[key] == pytest.approx(min(cs.STATE_ATOL, cs.STATE_REL * scale))
        assert rows_b["uout"] == pytest.approx(cs.READOUT_REL * np.abs(x64["uout"]).max())
    if case in DRAW_CASES:
        uout = next(r for r in rows if r["field"] == "uout")
        b = _bound("uout", x0)
        assert uout["b"] == pytest.approx(b) and uout["move"] == 0.0
        if case == "rounding_differs":
            assert uout["e0"][1] - uout["e0"][0] > b and uout["shift"] == 0.0
            assert uout["median"][0] == uout["median"][1]
            assert uout["further"] == 1 and uout["ratio"] == pytest.approx(1.0)
        elif case in ("shift_2b", "majority_past_b"):
            assert uout["shift"] > b and uout["median"][1] - uout["median"][0] > b
        elif case == "minority_past_b":
            assert uout["shift"] == 0.0 and uout["further"] == 3
        elif case == "spread_past_b":
            assert uout["shift"] == 0.0 and uout["further"] == 2
            assert uout["median"][1] - uout["median"][0] == pytest.approx(40 * b, rel=1e-3)


# the speed rule's cases: the first checkout's times (ms per 256 steps)
SPEED_TIMES = {"a": 3.55, "b": 3.71, "k": 2.81, "l": 4.60, "u": 3.69}
SPEED_CASES = ["within", "past_one", "turns_averaged"]


@pytest.mark.parametrize("case", SPEED_CASES)
def test_speed_rule(case, tmp_path):
    """``--ab``'s speed rule on synthetic means: a later checkout 0.1
    percentage point under the allowance on every case of AB_SPEED_CASES
    passes; 0.1 point past it on (k) alone fails on (k), named; the first
    checkout given twice, as in A B B A, averages its two turns (its first
    turn alone would refuse B).  ``ab_speed`` reads the same from saved
    times."""
    assert tuple(SPEED_TIMES) == cs.AB_SPEED_CASES
    # 0.1 point past the allowance on the cases ``past``, under it elsewhere
    up = lambda past: {tag: t * (1 + cs.AB_SPEED_ALLOWANCE + (1e-3 if tag in past else -1e-3))
                       for tag, t in SPEED_TIMES.items()}
    if case == "within":
        roots, times, want = ["A", "B"], [SPEED_TIMES, up(())], []
    elif case == "past_one":
        roots, times, want = ["A", "B"], [SPEED_TIMES, up(("k",))], ["k"]
    else:  # A's turns 2% apart; B 0.1 point under the allowance from their mean
        early = {tag: t / 1.01 for tag, t in SPEED_TIMES.items()}
        late = {tag: t * 1.01 for tag, t in SPEED_TIMES.items()}
        mean_a = {tag: (early[tag] + late[tag]) / 2 for tag in SPEED_TIMES}
        b = {tag: mean_a[tag] * (1 + cs.AB_SPEED_ALLOWANCE - 1e-3) for tag in SPEED_TIMES}
        roots, times, want = ["A", "B", "B", "A"], [early, b, b, late], []
        assert cs.speed_rule(roots[:2], times[:2])[1]["B"] == list(cs.AB_SPEED_CASES)
    mean, slower = cs.speed_rule(roots, times)
    assert slower == {"B": want}
    if case == "turns_averaged":
        assert mean["A"] == pytest.approx(mean_a) and mean["B"] == pytest.approx(b)
    paths = []
    for n, t in enumerate(times):
        paths.append(str(tmp_path / f"ab{n}.npz"))
        np.savez(paths[-1], times=np.array(json.dumps(t)))
    assert cs.ab_speed(roots, paths) == (want == [])
