"""Corpus attrition: would an exact float64 solve have dropped the draws a
run skipped?

    python -m torch_fdtd_string_tpu_torch.tools.attrition_study --run <run dir> \\
        [--controls 10] [--length 1.0] [--chunk 4] [--out results/attrition_study.json] \\
        [--cpu]

Port of the repository's ``tools/attrition_study.py``.  A production run
skips the strings its single-precision first pass turns NaN
(``experiment=nsynth-like`` sets ``task.rescue_nan=false``).  Run it with
``task.dump_draws=true`` and each string's whole draw lands in
``draw-<it>-<b>.npz`` with ``why`` ``nan`` or ``kept``
(``tasks/simulate.py::_dump_draw``).  This tool runs every skipped draw,
plus ``--controls`` kept draws chosen by ``np.random.default_rng(0)``,
through the port's float64 scan engine (``core/engine.py``, the coupled
solve by GMRES, as the rescue ladder's float64 stage runs it), ``--chunk``
draws per call over ``--length`` seconds, on the card unless ``--cpu``.
It writes the JAX tool's JSON to ``--out`` after every chunk (``rows``
with ``file``, ``group``, ``alpha``, ``f0``, ``p_a``, ``reference_nan``;
``length_s``, ``n_draws_total``, ``n_skipped``) and names its ``engine``:
the JAX tool runs the reference's C++ build, which no host of this
repository has.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..core.engine import SimConsts
from ..tasks.simulate import process_engine


def load_draws(run_dir):
    """Every ``draw-*.npz`` of ``run_dir``, sorted by name, as dicts with
    ``_file`` their name."""
    draws = []
    for path in sorted(glob.glob(os.path.join(run_dir, "draw-*.npz"))):
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        d["_file"] = os.path.basename(path)
        draws.append(d)
    return draws


def batch_inputs(draws, Nt):
    """:func:`tasks.simulate.process_engine`'s batch arguments for
    ``draws`` in float64 (JAX tool ``_batched_cfg``): the grid rows padded
    to the widest draw, the time signals cut or held at their last value
    to ``Nt``; the constants with the GMRES coupled solve."""
    B = len(draws)
    M_t = max(int(d["M_t"]) for d in draws)
    M_l = max(int(d["M_l"]) for d in draws)

    def pad(key):
        out = np.zeros((B, M_t))
        for i, d in enumerate(draws):
            v = np.asarray(d[key], np.float64).reshape(-1)
            out[i, :v.shape[0]] = v
        return out

    def stack(key):
        return np.stack([np.asarray(d[key], np.float64) for d in draws])

    def signal(key):
        out = np.zeros((B, Nt))
        for i, d in enumerate(draws):
            v = np.asarray(d[key], np.float64).reshape(-1)
            n = min(Nt, v.shape[0])
            out[i, :n] = v[:n]
            out[i, n:] = v[n - 1]
        return out

    bow_mask = stack("bow_mask").reshape(B).astype(bool)
    hammer_mask = stack("hammer_mask").reshape(B).astype(bool)
    first = draws[0]
    string = SimpleNamespace(u0=pad("u0"), v0=pad("v0"), kappa=stack("kappa"),
                             alpha=stack("alpha"), p_a=stack("p_a"), f0=signal("f0"),
                             pos=stack("pos"), T60=stack("T60"))
    bow = SimpleNamespace(x_b=signal("x_b"), v_b=signal("v_b"), F_b=signal("F_b"),
                          phi_0=stack("phi_0"), phi_1=stack("phi_1"), wid=signal("wid"))
    hammer = SimpleNamespace(u_H=signal("u_H"), x_H=stack("x_H"), w_H=stack("w_H"),
                             M_r=stack("M_r"), alpha=stack("alpha_H"))
    consts = SimConsts(
        k=float(first["k"]), theta_t=float(first["theta_t"]),
        lambda_c=float(first["lambda_c"]), relative_error=float(first["relative_error"]),
        M_t=M_t, M_l=M_l, surface_integral=bool(first["surface_integral"]),
        has_bow=bool(bow_mask.any()), has_hammer=bool(hammer_mask.any()),
        collect_state=False, coupling_solver="gmres", coupling_max_iter=64)
    return string, bow, hammer, bow_mask, hammer_mask, consts


def study(run_dir, controls=10, length=1.0, chunk=4, out=None, device=None):
    """Run the skipped draws and the controls; returns the JSON record
    (written to ``out`` after every chunk when given)."""
    draws = load_draws(run_dir)
    if not draws:
        raise FileNotFoundError(f"no draw-*.npz under {run_dir}; run the simulation with "
                                "task.dump_draws=true first")
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("attrition_study runs the float64 engine on a CUDA card and torch "
                           "finds none; pass --cpu to run it on the CPU")
    device = torch.device("cuda" if device is None else device)
    skipped = [d for d in draws if str(d["why"]) == "nan"]
    kept = [d for d in draws if str(d["why"]) == "kept"]
    rng = np.random.default_rng(0)
    chosen = [kept[i] for i in rng.choice(len(kept), size=min(controls, len(kept)),
                                          replace=False)] if kept else []
    print(f"[attrition] {len(draws)} dumped draws: {len(skipped)} skipped, {len(kept)} kept; "
          f"the float64 engine on {len(skipped)} skips + {len(chosen)} controls on {device}",
          flush=True)
    Nt = round(length / float(draws[0]["k"]))  # steps at the run's rate, 1 / k
    record = {"rows": [], "length_s": length, "n_draws_total": len(draws),
              "n_skipped": len(skipped),
              "engine": f"the port's float64 scan engine (core/engine.py, GMRES coupled "
                        f"solve) on {device.type}, not the reference's C++ build"}
    todo = [("skip", d) for d in skipped] + [("control", d) for d in chosen]
    for lo in range(0, len(todo), chunk):
        batch = todo[lo:lo + chunk]
        uout = process_engine(*batch_inputs([d for _, d in batch], Nt), Nt, Nt, device,
                              collect_state=False, skip_nan=True)[0]
        for (group, d), isnan in zip(batch, np.isnan(uout).any(axis=-1)):
            record["rows"].append({
                "file": d["_file"], "group": group,
                "alpha": round(float(d["alpha"]), 3),
                "f0": round(float(np.asarray(d["f0"]).reshape(-1)[2]), 2),
                "p_a": round(float(d["p_a"]), 4),
                "reference_nan": bool(isnan),
            })
            print(f"[attrition] {d['_file']} ({group}): alpha={record['rows'][-1]['alpha']} "
                  f"-> reference_nan={bool(isnan)}", flush=True)
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(record, f, indent=1, allow_nan=False)
    rows = record["rows"]
    n_skip = sum(r["reference_nan"] for r in rows if r["group"] == "skip")
    n_ctl = sum(r["reference_nan"] for r in rows if r["group"] == "control")
    print(f"[attrition] float64 NaN on {n_skip}/{len(skipped)} of the skips; "
          f"{n_ctl}/{len(chosen)} of the kept controls")
    print(f"[attrition] skipped-draw alpha range: "
          f"{sorted(r['alpha'] for r in rows if r['group'] == 'skip')}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, help="a run directory holding draw-*.npz")
    ap.add_argument("--controls", type=int, default=10)
    ap.add_argument("--length", type=float, default=1.0,
                    help="seconds of float64 simulation per draw")
    ap.add_argument("--chunk", type=int, default=4, help="draws per engine call")
    ap.add_argument("--out", default=os.path.join("results", "attrition_study.json"))
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    a = ap.parse_args(argv)
    return study(a.run, a.controls, a.length, a.chunk, a.out, "cpu" if a.cpu else None)


if __name__ == "__main__":
    main()
