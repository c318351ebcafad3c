"""The string kernel's partitioned tridiagonal solve (``ops/tridiag.py``).

``partition_factor`` / ``partition_solve`` are the plain version of the
solve in ``csrc/string_step.cu``: each string's live rows in 32 lane blocks,
eliminated locally to a 64-row reduced system solved by six PCR levels,
factored once per step.  Held here to a dense solve in float64 and to the
JAX kernel's PCR (``pcr_normalized``) in float32, on the tridiagonals of real
steps: the first nsynth-like batch (M_t, M_l) = (172, 262) and
linear-string's draw (283, 437), captured from the plain version's own
calls.  ~10 s on one worker.
"""

import math

import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.ops import tridiag as td
from torch_fdtd_string_tpu_torch.tools import profile_kernel as pk

NSYNTH = ["experiment=nsynth-like", "task.fuse_preprocess=false", "task.num_samples=24",
          "task.batch_size=24", "task.length=1.0"]


def _linear_string_args(T):
    """linear-string's own single-precision draw, as tests/test_torch_mms.py
    takes it."""
    from test_torch_mms import _linear_string_draw

    return _linear_string_draw("single", T)


def _capture(monkeypatch, args, kw, dtype):
    """The (sub, diag, sup, n) of every system the plain version factors over
    ``args``' steps, each with the right-hand sides it solves there."""
    systems = []

    def factor(sub, diag, sup, n):
        f = td.partition_factor(sub, diag, sup, n)
        systems.append(((sub, diag, sup, n), []))
        f_id[id(f)] = len(systems) - 1
        return f

    def solve(f, rhs):
        systems[f_id[id(f)]][1].append(rhs)
        return td.partition_solve(f, rhs)

    f_id = {}
    monkeypatch.setattr(sk, "partition_factor", factor)
    monkeypatch.setattr(sk, "partition_solve", solve)
    sk.string_chunked_reference(*(a.to(dtype) for a in args),
                                **dict(kw, coupling_iters=24))
    monkeypatch.undo()
    return systems


@pytest.fixture(scope="module")
def real_systems():
    """Captured float64 systems of 3 steps of each draw: (M_t, M_l) and the
    list of (system, right-hand sides)."""
    mp = pytest.MonkeyPatch()
    out = {}
    for name, (args, kw) in (("nsynth", pk.config_args(NSYNTH, torch.device("cpu"), 3)),
                             ("linear", _linear_string_args(3))):
        out[name] = ((kw["M_t"], kw["M_l"]), _capture(mp, args, kw, torch.float64))
    return out


def _dense(sub, diag, sup):
    return (torch.diag_embed(diag) + torch.diag_embed(sub[:, 1:], -1)
            + torch.diag_embed(sup[:, :-1], 1))


def _rel(got, want):
    return float(((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max())


@pytest.mark.parametrize("draw, shape", [("nsynth", (172, 262)), ("linear", (283, 437))])
def test_partition_solve_f64_matches_dense_solve(real_systems, draw, shape):
    """Every captured system (t and l, each step) and right-hand side of a
    real draw: the partitioned solve within 1e-12 of the solution's scale
    of a pivoting dense solve, rows past the live count included."""
    got_shape, systems = real_systems[draw]
    assert got_shape == shape
    assert len(systems) == 6  # two systems per step
    for (sub, diag, sup, n), rhss in systems:
        assert rhss
        f = td.partition_factor(sub, diag, sup, n)
        A = _dense(sub, diag, sup)
        for rhs in rhss:
            assert _rel(td.partition_solve(f, rhs), torch.linalg.solve(A, rhs)) < 1e-12


@pytest.mark.parametrize("draw", ["nsynth", "linear"])
def test_partition_solve_f32_matches_pcr(real_systems, draw):
    """In float32 against the JAX kernel's normalized PCR
    (``pcr_normalized`` at ceil(log2(W)) levels, pallas_step.py:184) on the
    same systems: within 2e-6 of the solution's scale.  Both round in float32 with no pivoting,
    each ~1e-7 of scale from the float64 solution on these diagonally
    dominant systems; 2e-6 leaves room for the reduction's different order
    and stays well inside 1e-5."""
    _, systems = real_systems[draw]
    for (sub, diag, sup, n), rhss in systems:
        sub, diag, sup = (x.float() for x in (sub, diag, sup))
        f = td.partition_factor(sub, diag, sup, n)
        levels = max(1, math.ceil(math.log2(sub.shape[1])))
        for rhs in rhss:
            want = td.pcr_normalized(sub, diag, sup, rhs.float(), levels)
            assert _rel(td.partition_solve(f, rhs.float()), want) < 2e-6


def _system(rng, W, ns, dtype=torch.float64):
    """Diagonally dominant random systems of live sizes ``ns`` padded to W
    with identity rows, as the string kernel lays them out."""
    B = len(ns)
    it = np.arange(W)[None, :]
    n = np.asarray(ns)[:, None]
    sub = np.where((it >= 1) & (it < n), rng.uniform(-1, 1, (B, W)), 0.0)
    sup = np.where(it < n - 1, rng.uniform(-1, 1, (B, W)), 0.0)
    diag = np.where(it < n, 2.5 + rng.uniform(0, 1, (B, W)), 1.0)
    rhs = rng.normal(size=(B, W))
    T = lambda x: torch.tensor(x, dtype=dtype)
    return T(sub), T(diag), T(sup), T(rhs), torch.tensor(ns)


def test_blocks_cover_the_live_rows():
    """Every live count from 0 to 1024: the blocks tile [0, n) in lane
    order, two rows or more each once n >= 2, at most 32 rows, and lanes
    past the blocks hold none."""
    n = torch.arange(0, 1025)
    start, size = td.partition_blocks(n)
    assert (size.sum(dim=1) == n).all()
    assert (start[:, 1:][size[:, 1:] > 0] == (start + size)[:, :-1][size[:, 1:] > 0]).all()
    assert (start[:, 0][n > 0] == 0).all()
    assert int(size.max()) == 32
    live = size > 0
    assert (size[n >= 2][live[n >= 2]] >= 2).all()
    assert (live[:, 1:] <= live[:, :-1]).all()  # the empty lanes come last


@pytest.mark.parametrize("R", range(1, 33))
def test_rows_per_lane_1_to_32(R):
    """Live counts whose longest block holds R rows (n = 1, 2, 3, then
    32 (R - 1) + 1), below W = 32 R: within 1e-12 of a dense float64 solve,
    the identity rows past n returned as their right-hand side."""
    n = {1: 1, 2: 2, 3: 3}.get(R, 32 * (R - 1) + 1)
    sub, diag, sup, rhs, ns = _system(np.random.default_rng(R), 32 * R, [n, max(n - 1, 0)])
    f = td.partition_factor(sub, diag, sup, ns)
    assert int(f.size.max()) == R
    x = td.partition_solve(f, rhs)
    assert _rel(x, torch.linalg.solve(_dense(sub, diag, sup), rhs)) < 1e-12
    for b, nb in enumerate(ns.tolist()):
        assert torch.equal(x[b, nb:], rhs[b, nb:])


def test_result_independent_of_padding_width():
    """The same live systems padded to 288 and to 1024 rows: the live rows'
    solutions equal bit for bit, as a string's result must not depend on
    its bucket's width."""
    sub, diag, sup, rhs, n = _system(np.random.default_rng(3), 288, [172, 262, 288, 65, 7])
    pad = lambda x, v: torch.nn.functional.pad(x, (0, 1024 - 288), value=v)
    x = td.partition_solve(td.partition_factor(sub, diag, sup, n), rhs)
    xw = td.partition_solve(td.partition_factor(pad(sub, 0.0), pad(diag, 1.0),
                                                pad(sup, 0.0), n), pad(rhs, 0.0))
    assert torch.equal(xw[:, :288], x)


def test_nan_row_stays_in_its_string():
    """A NaN right-hand side in one live row of one string: that string's
    live rows come back NaN, its identity rows keep their right-hand side,
    and every other string's solution equals its solution alone, bit for
    bit."""
    sub, diag, sup, rhs, n = _system(np.random.default_rng(5), 288,
                                     [172, 262, 100], dtype=torch.float32)
    f = td.partition_factor(sub, diag, sup, n)
    clean = td.partition_solve(f, rhs)
    rhs[1, 40] = float("nan")
    x = td.partition_solve(f, rhs)
    assert torch.isnan(x[1, :262]).all() and torch.equal(x[1, 262:], rhs[1, 262:])
    assert torch.equal(x[[0, 2]], clean[[0, 2]])
    alone = td.partition_solve(td.partition_factor(sub[:1], diag[:1], sup[:1], n[:1]),
                               rhs[:1])
    assert torch.equal(alone, x[:1])


def test_factor_once_solve_many_is_bit_for_bit():
    """Several right-hand sides through one factorization equal each solved
    through a factorization of its own, bit for bit (the kernel factors once
    per step and reuses it in every sweep and the rescue)."""
    rng = np.random.default_rng(9)
    sub, diag, sup, _, n = _system(rng, 448, [283, 437, 64, 3], dtype=torch.float32)
    f = td.partition_factor(sub, diag, sup, n)
    for _ in range(4):
        rhs = torch.tensor(rng.normal(size=(4, 448)), dtype=torch.float32)
        fresh = td.partition_solve(td.partition_factor(sub, diag, sup, n), rhs)
        assert torch.equal(td.partition_solve(f, rhs), fresh)


def test_live_rows_counts():
    """The live count of a float grid size: ceil, clipped to [0, W]; NaN
    counts 0."""
    n = torch.tensor([[173.0], [172.5], [0.0], [-3.0], [float("nan")], [float("inf")],
                      [2000.0]])
    assert td.live_rows(n, 288).tolist() == [173, 173, 0, 0, 0, 288, 288]
