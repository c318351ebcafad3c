"""Throughput of the string kernel over the batch size.

    python -m torch_fdtd_string_tpu_torch.tools.batch_sweep [--batches 16,32,64,128,256] \\
        [--length 1.0] [--reps 3] [--cpu]

Port of the repository's ``tools/batch_sweep.py``: throughput should not
fall as the batch grows.  Each point times ``pluck_chunked`` over the bench
workload (``tasks/time_experiment.py::kernel_point``) and prints one JSON
line (``B``, ``length_s``, ``audio_s_per_s``, ...); the last line says
whether each point's rate is at least 0.9 times the one before
(``monotone_within_10pct``).  Runs on the card unless ``--cpu`` (the
kernel's plain version), and raises without one; a point that fails
raises.
"""

from __future__ import annotations

import argparse
import json

from ..tasks.time_experiment import kernel_point, sweep_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="16,32,64,128,256")
    ap.add_argument("--length", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="time the plain version on the CPU")
    a = ap.parse_args(argv)
    device = sweep_device("cpu" if a.cpu else None)
    rows = []
    for B in (int(b) for b in a.batches.split(",")):
        rows.append(kernel_point(B, a.length, device, a.reps))
        print(json.dumps(rows[-1]), flush=True)
    rates = [r["audio_s_per_s"] for r in rows]
    # non-decreasing within 10% between neighbouring points
    mono = all(b >= 0.9 * a2 for a2, b in zip(rates, rates[1:]))
    print(json.dumps({"monotone_within_10pct": mono, "rates": rates}), flush=True)
    return rows


if __name__ == "__main__":
    main()
