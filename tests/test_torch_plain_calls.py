"""chip_smoke.py's record and replay of phase 3's plain versions
(``PlainCalls``, ``call_key``), on the CPU at a small size.

On the card a child process records every plain call of phase 3 while the
main process runs phases 4-18, and the main process's phase 3 then reads
each result back, once the digest of its own call's arguments equals the
recorded one.  Here the same classes record and replay the plain versions
on CPU tensors.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def draw():
    return cs.truncate(cs.bench_inputs(2, 0.02, 7, CPU), 12)


def calls(draw):
    """Phase 3's three plain versions, as it calls them (through the module)."""
    args, kw = draw
    hb = cs.host_bounds(args)
    plain = sk.string_chunked_reference(*args, **kw)
    fixed = sk.string_chunked_reference(*args, **dict(kw, coupling_fixed=2))
    bucketed = sk.string_chunked_bucketed_reference(*args, host_bounds=hb, **kw)
    gk = dict(kw, gmres_rescue=True)
    out = sk.string_chunked_bucketed(*args, host_bounds=hb, **kw)
    rerun = sk.string_chunked_rerun_reference(*args, rows=np.array([1]), out=out,
                                              host_bounds=hb, **gk)
    return plain, fixed, bucketed, rerun


def flat(out):
    uo, zo, aux = out
    return [uo, zo] + [v for k, v in sorted(aux.items()) if torch.is_tensor(v)] + [
        x for x in aux.get("carry", ())]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b), strict=True))


def test_replay_returns_the_recorded_results(draw, tmp_path):
    """Recorded calls are read back equal, one file each, with their
    milliseconds; outside the ``with`` the module's functions are the
    plain versions again."""
    originals = {name: getattr(sk, name) for name in cs.PLAIN_FNS}
    want = calls(draw)
    with cs.PlainCalls("record", str(tmp_path)) as rec:
        recorded = calls(draw)
    assert rec.n == 4 and rec.saved() == 4
    assert all(getattr(sk, name) is fn for name, fn in originals.items())
    assert cs.PlainCalls.last_ms is None
    for a, b in zip(want, recorded):
        assert same(a, b)
    with cs.PlainCalls("replay", str(tmp_path)) as rep:
        replayed = calls(draw)
        assert cs.PlainCalls.last_ms >= 0.0
    assert rep.n == 4
    for a, b in zip(want, replayed):
        assert same(a, b)
    assert all(getattr(sk, name) is fn for name, fn in originals.items())


def test_replay_refuses_other_arguments(draw, tmp_path):
    """A replayed call whose arguments differ from the recorded call's by
    one float32 ulp raises; so does a call past the recorded ones."""
    args, kw = draw
    with cs.PlainCalls("record", str(tmp_path)):
        sk.string_chunked_reference(*args, **kw)
    moved = cs.ulp_perturbed(args)
    with cs.PlainCalls("replay", str(tmp_path)):
        with pytest.raises(AssertionError, match="differ from the recorded"):
            sk.string_chunked_reference(*moved, **kw)
    with cs.PlainCalls("replay", str(tmp_path)):
        sk.string_chunked_reference(*args, **kw)
        with pytest.raises(AssertionError, match="was not recorded"):
            sk.string_chunked_reference(*args, **kw)
    with cs.PlainCalls("replay", str(tmp_path)):
        with pytest.raises(AssertionError, match="differ from the recorded"):
            sk.string_chunked_bucketed_reference(*args, **kw)


def test_call_key_reads_every_argument():
    """The digest follows dtype, shape, every value, nested dicts (not
    their order), arrays and scalars."""
    x = torch.arange(6.0).reshape(2, 3)
    base = cs.call_key("f", (x,), {"a": 1.0, "b": {"c": np.arange(3)}})
    assert base == cs.call_key("f", (x.clone(),), {"b": {"c": np.arange(3)}, "a": 1.0})
    y = x.clone()
    y[1, 2] = torch.nextafter(y[1, 2], torch.tensor(10.0))
    for other in (cs.call_key("g", (x,), {"a": 1.0, "b": {"c": np.arange(3)}}),
                  cs.call_key("f", (y,), {"a": 1.0, "b": {"c": np.arange(3)}}),
                  cs.call_key("f", (x.double(),), {"a": 1.0, "b": {"c": np.arange(3)}}),
                  cs.call_key("f", (x.reshape(3, 2),), {"a": 1.0, "b": {"c": np.arange(3)}}),
                  cs.call_key("f", (x,), {"a": 2.0, "b": {"c": np.arange(3)}}),
                  cs.call_key("f", (x,), {"a": 1.0, "b": {"c": np.arange(4)}})):
        assert other != base
