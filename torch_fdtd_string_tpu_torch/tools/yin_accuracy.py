"""The YIN f0 tracker against analytic ground truth.

    python -m torch_fdtd_string_tpu_torch.tools.yin_accuracy [--n 50] [--seed 0] \\
        [--out results/yin_accuracy.md]

Port of the repository's ``tools/yin_accuracy.py``.  The reference tracks
f0 with CREPE (reference ``src/utils/analysis/frequency.py:4-9``); the
port's tracker is two-stage YIN (``utils/frequency.py``).  This tool
bounds its error against known truth: ``n`` modal tones synthesised from
the analytic lossy stiff string (``core/analytic.py::lossy_stiff_string``,
one pickup of ``ops/modal.py::modal_synth_nyquist_np``), whose fundamental
is the exact mode-1 frequency, each tracked by
``compute_harmonic_parameters`` and scored by its track's median.  The
draws come from ``np.random.default_rng(seed)`` in the JAX tool's order,
so both tools score the same tones.  Prints the table and writes it to
``--out``.  Host numpy: no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core import analytic
from ..ops.modal import modal_synth_nyquist_np
from ..utils.frequency import compute_harmonic_parameters


def tone_rows(n=50, sr=48000, seed=0):
    """``(f0, kappa, true f0, YIN f0, |error|)`` in Hz per tone, for ``n``
    one-second tones drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rows = []
    Nt, Na = sr, 512
    for _ in range(n):
        f0 = float(rng.uniform(98.0, 440.0))
        kr = float(rng.uniform(0.01, 0.03))
        t60 = np.array([[100.0, rng.uniform(10, 25)], [1000.0, rng.uniform(10, 30)]])
        p_x = float(rng.uniform(0.2, 0.8))
        # a triangular pluck on the analytic grid
        x = np.linspace(0, 1, Na)
        u0 = np.where(x < p_x, x / max(p_x, 1e-6), (1 - x) / max(1 - p_x, 1e-6)) * 0.01
        _, mode_freq, mode_amps = analytic.lossy_stiff_string(
            u0, f0, kr, t60, Nt, Na, sr, strict=False, return_field=False)
        f_true = float(mode_freq[0]) * sr / (2 * np.pi)  # the lowest mode, rad/sample -> Hz
        wav = modal_synth_nyquist_np(np.tile(mode_freq[None, :], (Nt, 1)),
                                     mode_amps.T[Na // 3:Na // 3 + 1],  # one pickup
                                     np.ones(Nt), sr)[:, 0]
        wav = wav / (np.sqrt(np.mean(wav**2)) + 1e-12)
        f_est = float(np.median(compute_harmonic_parameters(wav, sr)["f0"]))
        rows.append((f0, kr, f_true, f_est, abs(f_est - f_true)))
    return rows


def table(rows):
    """The markdown table of the rows' absolute, relative and cents errors."""
    rows = np.asarray(rows, np.float64)
    errs, f_true, f_est = rows[:, 4], rows[:, 2], rows[:, 3]
    rel = errs / f_true
    cents = 1200 * np.abs(np.log2(f_est / f_true))
    stats = (("mean", np.mean), ("median", np.median),
             ("p95", lambda v: np.percentile(v, 95)), ("max", np.max))
    return "\n".join([
        "# YIN f0-tracker accuracy vs analytic ground truth",
        "",
        f"{len(rows)} modal tones from `core/analytic.py::lossy_stiff_string` "
        "(f0 ~ U(98, 440) Hz, kappa ~ U(0.01, 0.03), random T60 and pluck): the "
        "tone's true fundamental is the exact mode-1 frequency; error of the YIN "
        "track's median (`utils/frequency.py`):",
        "",
        "| statistic | abs error (Hz) | rel error | cents |",
        "|---|---|---|---|",
        *(f"| {name} | {fn(errs):.4f} | {fn(rel):.2e} | {fn(cents):.3f} |"
          for name, fn in stats),
        "",
    ])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("results", "yin_accuracy.md"))
    a = ap.parse_args(argv)
    rows = tone_rows(a.n, a.sr, a.seed)
    md = table(rows)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(md)
    print(md)
    print(f"-> {a.out}")
    return rows


if __name__ == "__main__":
    main()
