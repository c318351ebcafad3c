"""How far a checkout's float32 string step lies from float64, and how that
distance spreads when the inputs move by one float32 ulp.

Runs the plain version of ``string_chunked`` on the CPU (no card needed) on
draw (a), ``chip_smoke.bench_inputs(4, 0.02, 7)`` over 256 steps, with the
given sweep schedule, on the draws that ``chip_smoke.py --ab --float64``
holds a case over: the unperturbed inputs and, for each seed of
``--seeds``, u1 and u2 moved up by one float32 ulp at random entries, all
stacked along the batch axis (``chip_smoke.stacked_draws``).  It runs them
in float32 and cast to float64, and prints, per draw and field, the
float32 result's largest distance from float64 over the entries finite in
both (``chip_smoke.string_errors``).  Two checkouts whose arithmetic
differs are compared by running this script once on each, then comparing
the two files::

    python tools/float_spread.py --root PARENT --seeds 32 --json parent.json
    python tools/float_spread.py --root . --seeds 32 --json change.json
    python tools/float_spread.py --compare parent.json change.json

The draws, the distances, b and the statistics are those of the
``chip_smoke.py`` beside this script (loaded by path, since the checkout
given with ``--root`` has a chip_smoke of its own); of that checkout the
script uses ``chip_smoke.bench_inputs``, ``chip_smoke.truncate`` and
``string_kernel.string_chunked``.  With ``--json`` it saves its readings;
``--compare FIRST.json LATER.json`` then reads two such files (the same
schedule and seeds) and prints, per field, what ``--ab --float64`` prints
(``chip_smoke.draw_rule``: the unperturbed draw's distances, the medians,
on how many draws the later lies further, the geometric mean of the ratio,
the verdict; b at the unperturbed float64 field's scale,
``chip_smoke.field_bounds``; no float64 move, which the files do not
hold), the means, and how often, over the same inputs, one draw alone
would refuse the later checkout (its distance over the first's plus b),
and the first as the later.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

FIELDS = ("uout", "zout", "state_u", "state_z", "u1", "z1")


def gate():
    """The chip_smoke.py beside this script, as a module of its own name."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("float64_gate", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def distances(gm, sk, inputs, draws):
    """Per draw and field, the float32 result's largest distance from
    float64 over the strings finite in float32; and the unperturbed float64
    field's scale."""
    args, kw = gm.stacked_draws(inputs, draws)
    fields = lambda out: {key: x.numpy() for key, x in gm.named_fields(out) if key in FIELDS}
    got = fields(sk.string_chunked(*args, **kw))
    a64, kw64 = gm.cast_inputs((args, kw), torch.float64)
    ref = fields(sk.string_chunked(*a64, **kw64))
    B = inputs[0][0].shape[0]
    e = {key: gm.draw_errors(err, fin, draws)
         for key, (err, fin) in gm.string_errors(ref, got).items()}
    scale = {key: float(np.abs(x[np.isfinite(x)]).max())
             for key, x in ((key, gm.draw_block(key, x, 0, B)) for key, x in ref.items())}
    return e, scale


def compare(first_path, later_path):
    """Per field, the two checkouts' readings under ``--ab --float64``'s
    rule, their means, and on how many of the same draws one draw alone
    would refuse each as the later checkout against the other."""
    gm = gate()
    first, later = (json.load(open(p)) for p in (first_path, later_path))
    seeds = sorted(set(first["rows"]) & set(later["rows"]), key=int)
    print(f"{first['root']} -> {later['root']}, coupling_fixed {first['fixed']}, "
          f"{len(seeds)} draws")
    bounds = gm.field_bounds({key: np.float64(v) for key, v in first["scale"].items()})
    for key in FIELDS:
        b = bounds[key]
        e_a = np.array([first["rows"][s][key] for s in seeds])
        e_c = np.array([later["rows"][s][key] for s in seeds])
        r = gm.draw_rule(e_a, e_c, b)
        print(f"{key:8s} b {b:.4e}  median {r['median'][0]:.4e} -> {r['median'][1]:.4e} "
              f"({'held' if r['ok'] else 'refused'})  mean {e_a.mean():.4e} -> "
              f"{e_c.mean():.4e}  draw 0 {r['e0'][0]:.4e} -> {r['e0'][1]:.4e}  later further "
              f"on {r['further']}/{r['n']}, geometric mean of later/first {r['ratio']:.3f} "
              f"(standard error of its log {r['se']:.3f})  one draw refuses later "
              f"{int((e_c > e_a + b).sum())}/{r['n']}, first as later "
              f"{int((e_a > e_c + b).sum())}/{r['n']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose plain version runs")
    ap.add_argument("--fixed", type=int, default=2, help="coupling_fixed (0: adaptive)")
    ap.add_argument("--seeds", type=int, default=8, help="ulp-perturbed draws (1..N)")
    ap.add_argument("--json", help="write the readings here as JSON")
    ap.add_argument("--compare", nargs=2, metavar=("FIRST", "LATER"),
                    help="compare two --json files instead of running")
    opt = ap.parse_args()
    if opt.compare:
        compare(*opt.compare)
        return
    root = os.path.abspath(opt.root)
    gm = gate()
    sys.path.insert(0, root)
    import chip_smoke as cs
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    torch.set_num_threads(2)
    args, kw = cs.truncate(cs.bench_inputs(4, 0.02, 7, torch.device("cpu")), 256)
    e, scale = distances(gm, sk, (args, dict(kw, coupling_fixed=opt.fixed)), opt.seeds + 1)
    rows = {seed: {key: float(e[key][seed]) for key in FIELDS} for seed in range(opt.seeds + 1)}
    for seed, row in rows.items():
        print(f"seed {seed}: " + " ".join(f"{k} {v:.4e}" for k, v in row.items()))
    summary = {}
    for key in FIELDS:
        summary[key] = {"median": float(np.median(e[key])), "mean": float(e[key].mean()),
                        "min": float(e[key].min()), "max": float(e[key].max())}
        print(f"{key:8s} " + " ".join(f"{k} {v:.4e}" for k, v in summary[key].items()))
    if opt.json:
        with open(opt.json, "w") as f:
            json.dump({"root": root, "fixed": opt.fixed, "rows": rows, "scale": scale,
                       "summary": summary}, f)


if __name__ == "__main__":
    main()
