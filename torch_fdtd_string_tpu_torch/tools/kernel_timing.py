"""A/B timing and equivalence probe of the string kernel's sweep schedules.

    python -m torch_fdtd_string_tpu_torch.tools.kernel_timing [reps]

PyTorch port of the JAX package's ``tools/kernel_timing.py``.  Times the
default pluck workload (``tasks/time_experiment.py::build_workload``, 1 s)
at B=16 and B=256 under the adaptive Gauss-Seidel exit (``adaptive``) and a
fixed count of plain sweeps (``fixed1``, ``fixed2``: ``coupling_fixed`` 1
and 2), each with ``string_chunked``'s defaults as the JAX tool calls it.
Reports each variant's median wall over ``reps`` calls (CUDA events),
audio-seconds per second, and each fixed variant's largest deviation of
``uout`` from the adaptive one over the strings both runs keep finite,
relative to the adaptive run's scale (and the count of strings the fixed
schedule lets diverge), so that a faster schedule is adopted only with
evidence.  Prints one JSON line.  The JAX tool's
``fixed2_c2048`` variant, another TPU time-chunk size, has no counterpart:
the CUDA kernel runs all steps in one launch.

Runs on the CUDA card; ``run_timing(device="cpu")`` times the plain
version instead.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..ops.string_kernel import string_chunked
from ..tasks.time_experiment import build_workload, call_seconds, sweep_device

VARIANTS = {"adaptive": {}, "fixed1": {"coupling_fixed": 1},
            "fixed2": {"coupling_fixed": 2}}
SIZES = ((16, 1.0), (256, 1.0))


def run_timing(reps=5, device=None, sizes=SIZES, sr=48000):
    """``{"b{B}_{variant}": {"wall_s", "audio_s_per_s"[,
    "max_rel_dev_vs_adaptive"]}}`` for each size ``(B, length)``."""
    device = sweep_device(device)
    results = {}
    for B, length in sizes:
        carry, _, sp, _, _, _, _, consts = build_workload(
            B=B, length=length, sr=sr, device=device)[0]
        T = (sp.f0.shape[1] - 2) // 512 * 512
        f0 = sp.f0[:, 2 : 2 + T].contiguous()

        def run(**kw):
            return string_chunked(
                f0, sp.kappa, sp.alpha, sp.pos, sp.T60, carry.u1, carry.u2,
                carry.z1, carry.z2, k=consts.k, theta_t=consts.theta_t,
                lambda_c=consts.lambda_c, M_t=consts.M_t, M_l=consts.M_l,
                coupling_iters=24, surface_integral=consts.surface_integral, **kw)

        outs = {}
        for name, kw in VARIANTS.items():
            outs[name] = run(**kw)[0].double().cpu().numpy()  # also the warm-up
            wall = float(np.median([call_seconds(lambda: run(**kw), device)
                                    for _ in range(reps)]))
            results[f"b{B}_{name}"] = {"wall_s": wall,
                                       "audio_s_per_s": B * T / sr / wall}
            print(f"B={B} {name}: {results[f'b{B}_{name}']}", flush=True)
        fin = np.isfinite(outs["adaptive"]).all(axis=1)
        scale = np.abs(outs["adaptive"][fin]).max(initial=0.0) + 1e-12
        for name in ("fixed1", "fixed2"):
            # a fixed schedule poisons nothing: a string it lets diverge is
            # counted, not compared
            ok = fin & np.isfinite(outs[name]).all(axis=1)
            dev = np.abs(outs[name][ok] - outs["adaptive"][ok]).max(initial=0.0) / scale
            results[f"b{B}_{name}"].update(max_rel_dev_vs_adaptive=float(dev),
                                           nonfinite_strings=int((fin & ~ok).sum()))
            print(f"B={B} {name} max rel dev vs adaptive: {dev:.3e}, strings it "
                  f"leaves non-finite: {int((fin & ~ok).sum())}", flush=True)
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(json.dumps(run_timing(int(argv[0]) if argv else 5), allow_nan=False))


if __name__ == "__main__":
    main()
