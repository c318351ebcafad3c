"""Throughput of the string kernel over the simulated length.

    python -m torch_fdtd_string_tpu_torch.tools.length_sweep [--B 64] \\
        [--lengths 0.25,0.5,1,2,4] [--reps 3] [--cpu]

Port of the repository's ``tools/length_sweep.py``, the reference's second
scaling axis (Nt over 0.25-4 s at 48 kHz, reference plot.py:828,860-861):
a step costs the same at any length, so throughput should stay about flat.
Each point times ``pluck_chunked`` over the bench workload at batch
``--B`` (``tasks/time_experiment.py::kernel_point``) and prints one JSON
line, as ``tools/batch_sweep.py`` does; the last line gives the largest
rate over the smallest (``throughput_spread``).  Runs on the card unless
``--cpu`` (the kernel's plain version), and raises without one; a point
that fails raises.
"""

from __future__ import annotations

import argparse
import json

from ..tasks.time_experiment import kernel_point, sweep_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--lengths", default="0.25,0.5,1,2,4")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="time the plain version on the CPU")
    a = ap.parse_args(argv)
    device = sweep_device("cpu" if a.cpu else None)
    rows = []
    for length in (float(x) for x in a.lengths.split(",")):
        rows.append(kernel_point(a.B, length, device, a.reps))
        print(json.dumps(rows[-1]), flush=True)
    rates = [r["audio_s_per_s"] for r in rows]
    print(json.dumps({"throughput_spread": max(rates) / min(rates), "rates": rates}),
          flush=True)
    return rows


if __name__ == "__main__":
    main()
