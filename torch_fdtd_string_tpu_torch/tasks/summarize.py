"""Summarize evaluation results across a results directory.

Port of ``torch_fdtd_string_tpu/tasks/summarize.py``: the mean, median and
standard deviation of every score column, from ``evaluation.txt`` or else
from the items' ``string_params.txt``, into ``summary.txt``.  The figures
wait for the port's plots (ROADMAP.md Queue 1 item 12).

    python -m torch_fdtd_string_tpu_torch.run proc.simulate=false \\
        proc.summarize=true task.load_dir=<simulation run>
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _read_rows(load_dir):
    """``(header, rows)`` of ``evaluation.txt``, or of the per-item files.

    Per-item rows are keyed by their whole header tuple, so two formats of
    one width that rename or reorder columns never merge positionally; of
    mixed formats the widest, then the most common, is kept."""
    path = os.path.join(load_dir, "evaluation.txt")
    if os.path.exists(path):
        with open(path) as f:
            header = f.readline().strip().split("\t")[1:]
            rows = [[float(v) for v in line.strip().split("\t")[1:]] for line in f]
        return header, rows
    by_header = {}
    for p in sorted(glob.glob(f"{load_dir}/*/string_params.txt")):
        keys, vals = [], []
        with open(p) as f:
            for line in f:
                k, v = line.strip().split("\t")
                keys.append(k)
                vals.append(float(v))
        by_header.setdefault(tuple(keys), []).append(vals)
    if not by_header:
        return None, []
    best = max(by_header, key=lambda h: (len(h), len(by_header[h])))
    dropped = sum(len(v) for h, v in by_header.items() if h != best)
    if dropped:
        print(f"[summarize] mixed column formats; dropping {dropped} "
              f"item(s) whose header differs from {list(best)[:4]}...")
    return list(best), by_header[best]


def summarize(load_dir):
    """Write ``summary.txt`` and return ``{"mean", "median", "std"}`` (one
    value per column), or None when ``load_dir`` holds no scores."""
    header, rows = _read_rows(load_dir)
    if not rows:
        print(f"[summarize] nothing to summarize in {load_dir}")
        return None
    arr = np.asarray(rows)
    stats = {
        "mean": arr.mean(axis=0),
        "median": np.median(arr, axis=0),
        "std": arr.std(axis=0),
    }
    out = os.path.join(load_dir, "summary.txt")
    with open(out, "w") as f:
        f.write("stat\t" + "\t".join(header) + "\n")
        for name, vals in stats.items():
            f.write(name + "\t" + "\t".join(f"{v:.4f}" for v in vals) + "\n")
    print(f"[summarize] {len(rows)} items -> {out}")
    print("[summarize] the summary figures are not ported yet (ROADMAP.md Queue 1 item 12)")
    return stats
