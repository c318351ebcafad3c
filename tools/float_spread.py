"""How far a checkout's float32 string step lies from float64, and how that
distance spreads when the inputs move by one float32 ulp.

Runs the plain version of ``string_chunked`` on the CPU (no card needed) on
draw (a), ``chip_smoke.bench_inputs(4, 0.02, 7)`` over 256 steps, with the
given sweep schedule.  For the unperturbed inputs and for each seed of
``--seeds`` (u1 and u2 moved up by one float32 ulp at random entries), it
runs float32 and the same inputs cast to float64, and prints, per field,
the float32 result's largest distance from float64 over the entries finite
in both.  Two checkouts whose arithmetic differs are compared by running
this script once on each, then comparing the two files::

    python tools/float_spread.py --root PARENT --seeds 32 --json parent.json
    python tools/float_spread.py --root . --seeds 32 --json change.json
    python tools/float_spread.py --compare parent.json change.json

The script uses only ``chip_smoke.bench_inputs``, ``chip_smoke.truncate``
and ``string_kernel.string_chunked`` of the checkout it is given.  With
``--json`` it saves its readings; ``--compare FIRST.json LATER.json`` then
reads two such files (the same schedule and seeds) and prints, per field,
the medians and means, on how many draws the later checkout lies further
from float64 and the geometric mean of the ratio, and how often, over the
same inputs, the later checkout's distance exceeds the first's by more
than b, and the first's the later's: b is the bound that
``chip_smoke.py --ab --float64`` allows (``chip_smoke.float64_case``, at
the unperturbed float64 field's scale).  Two equally accurate roundings
are refused about as often in either order.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

FIELDS = ("uout", "zout", "state_u", "state_z", "u1", "z1")


def perturbed(args, seed):
    """The args with u1 and u2 (args 5 and 6) each moved up by one float32
    ulp at about half their entries, drawn from ``seed``; seed 0 leaves
    them as they are."""
    if seed == 0:
        return tuple(args)
    rng = np.random.default_rng(seed)
    out = list(args)
    for i in (5, 6):
        x = args[i]
        up = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5)
        out[i] = torch.where(up, torch.nextafter(x, torch.full_like(x, float("inf"))), x)
    return tuple(out)


def cast(inputs, dtype):
    """Every floating tensor of a call's args and kwargs cast to ``dtype``."""
    c = lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
    args, kw = inputs
    kw = {k: ({kk: c(vv) for kk, vv in v.items()} if isinstance(v, dict) else c(v))
          for k, v in kw.items()}
    return tuple(c(a) for a in args), kw


def fields(out):
    """The compared fields of one ``string_chunked`` result."""
    uout, zout, aux = out
    return {"uout": uout, "zout": zout, "state_u": aux["state_u"], "state_z": aux["state_z"],
            "u1": aux["carry"][0], "z1": aux["carry"][2]}


def distances(sk, args, kw):
    """Per field, the float32 result's largest distance from float64, and
    the float64 field's scale."""
    got = fields(sk.string_chunked(*args, **kw))
    a64, kw64 = cast((args, kw), torch.float64)
    ref = fields(sk.string_chunked(*a64, **kw64))
    out, scale = {}, {}
    for key in FIELDS:
        x, r = got[key].double(), ref[key]
        fin = torch.isfinite(x) & torch.isfinite(r)
        out[key] = float((x - r).abs()[fin].max())
        scale[key] = float(r[torch.isfinite(r)].abs().max())
    return out, scale


def compare(first_path, later_path):
    """Per field, the two checkouts' median and mean distances over the
    draws, the paired ratio of later to first, and on how many of the same
    draws each would be refused as the later checkout against the other: a
    distance over the other's plus b."""
    import chip_smoke as cs

    first, later = (json.load(open(p)) for p in (first_path, later_path))
    seeds = sorted(set(first["rows"]) & set(later["rows"]), key=int)
    print(f"{first['root']} -> {later['root']}, coupling_fixed {first['fixed']}, "
          f"{len(seeds)} draws")
    for key in FIELDS:
        scale = first["scale"][key]
        b = (min(cs.STATE_ATOL, cs.STATE_REL * scale) if key in cs.STATE_FIELDS
             else cs.READOUT_REL * scale)
        e_a = np.array([first["rows"][s][key] for s in seeds])
        e_c = np.array([later["rows"][s][key] for s in seeds])
        log = np.log(e_c / e_a)
        print(f"{key:8s} b {b:.4e}  median {np.median(e_a):.4e} -> {np.median(e_c):.4e}  "
              f"mean {e_a.mean():.4e} -> {e_c.mean():.4e}  draw 0 {e_a[0]:.4e} -> "
              f"{e_c[0]:.4e}  later further on {int((e_c > e_a).sum())}/{len(seeds)}, "
              f"geometric mean of later/first {np.exp(log.mean()):.3f} (standard error "
              f"of its log {log.std(ddof=1) / np.sqrt(len(log)):.3f})  later refused "
              f"{int((e_c > e_a + b).sum())}/{len(seeds)}, first refused as later "
              f"{int((e_a > e_c + b).sum())}/{len(seeds)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose plain version runs")
    ap.add_argument("--fixed", type=int, default=2, help="coupling_fixed (0: adaptive)")
    ap.add_argument("--seeds", type=int, default=8, help="ulp-perturbed draws (1..N)")
    ap.add_argument("--json", help="write the readings here as JSON")
    ap.add_argument("--compare", nargs=2, metavar=("FIRST", "LATER"),
                    help="compare two --json files instead of running")
    opt = ap.parse_args()
    root = os.path.abspath(opt.root)
    sys.path.insert(0, root)
    if opt.compare:
        compare(*opt.compare)
        return
    import chip_smoke as cs
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    torch.set_num_threads(2)
    args, kw = cs.truncate(cs.bench_inputs(4, 0.02, 7, torch.device("cpu")), 256)
    kw = dict(kw, coupling_fixed=opt.fixed)
    rows = {}
    for seed in range(opt.seeds + 1):
        rows[seed], scale = distances(sk, perturbed(args, seed), kw)
        if seed == 0:
            scale0 = scale
        print(f"seed {seed}: " + " ".join(f"{k} {v:.4e}" for k, v in rows[seed].items()),
              flush=True)
    summary = {}
    for key in FIELDS:
        e = np.array([rows[s][key] for s in rows])
        summary[key] = {"median": float(np.median(e)), "mean": float(e.mean()),
                        "min": float(e.min()), "max": float(e.max())}
        print(f"{key:8s} median {np.median(e):.4e} mean {e.mean():.4e} "
              f"min {e.min():.4e} max {e.max():.4e}")
    if opt.json:
        with open(opt.json, "w") as f:
            json.dump({"root": root, "fixed": opt.fixed, "rows": rows, "scale": scale0,
                       "summary": summary}, f)


if __name__ == "__main__":
    main()
