"""Summarize evaluation results across a results directory.

Port of ``torch_fdtd_string_tpu/tasks/summarize.py``: the mean, median and
standard deviation of every score column, from ``evaluation.txt`` or else
from the items' ``string_params.txt``, into ``summary.txt``; and, best
effort as in the JAX package (a host without matplotlib prints that it
skipped them), ``summary_f0.pdf`` and ``summary_detune.pdf``.

    python -m torch_fdtd_string_tpu_torch.run proc.simulate=false \\
        proc.summarize=true task.load_dir=<simulation run>
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils import plot as uplot


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
    try:
        _figures(load_dir, header, arr)
    except Exception as err:  # the figures are best-effort (JAX summarize.py:100)
        print(f"[summarize] plot skipped: {err!r}")
    return stats


def _figures(load_dir, header, arr):
    """The estimated against the target f0, and the detune scatters over
    the sampled parameters (reference plot.py:682-820 scatter_kappa /
    scatter_pluck role; JAX summarize.py:70-98)."""
    plt = uplot.pyplot()
    if "f0_target_mean" in header and "f0_estimate" in header:
        ti = header.index("f0_target_mean")
        ei = header.index("f0_estimate")
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.scatter(arr[:, ti], arr[:, ei], s=8)
        lim = [arr[:, ti].min() * 0.9, arr[:, ti].max() * 1.1]
        ax.plot(lim, lim, "k--", lw=0.5)
        ax.set_xlabel("target f0 (Hz)")
        ax.set_ylabel("estimated f0 (Hz)")
        fig.tight_layout()
        fig.savefig(os.path.join(load_dir, "summary_f0.pdf"), dpi=120)
        plt.close(fig)
    if "kappa" in header:
        def col(k):
            return arr[:, header.index(k)] if k in header else None

        detunes = {
            r"$|f_0^{\tt est} - f_0|$": col("abs_diff_input"),
            r"$|f_0^{\tt est} - \hat{f_0}|$": col("abs_diff_target"),
        }
        detunes = {k: v for k, v in detunes.items() if v is not None}
        uplot.detune_scatter(os.path.join(load_dir, "summary_detune.pdf"), detunes,
                             col("kappa"), col("alpha"), col("p_x"), col("p_a"))
