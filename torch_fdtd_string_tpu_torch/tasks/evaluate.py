"""Evaluate simulated outputs: the f0 and detune scores of each item.

Port of ``torch_fdtd_string_tpu/tasks/evaluate.py`` (reference
``src/task/evaluate.py``).  Per simulation directory of the classic
archival contract: track the output's f0 (two-stage YIN in place of
CREPE), compare it with the input f0, the precorrected target f0 and the
Fletcher-theory prediction of the first mode, and write
``string_params.txt``; over the run, ``evaluation.txt``.  With ``plot``
(``task.plot``; the JAX package always draws) each item's rainbowgrams
and the run's detune scatters (``utils/plot.py``).  Host numpy: it chooses
no device.

    python -m torch_fdtd_string_tpu_torch.run experiment=evaluate \\
        task.load_dir=<simulation run>
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..ops import fdm
from ..utils import plot as uplot
from ..utils import wav as wavio
from ..utils.frequency import compute_harmonic_parameters
from ..utils.vnv import relative_detune_error


def evaluate_dir(sim_dir, sr=48000, plot=False):
    """The item's score dict, also written to ``string_params.txt``; None
    for a directory without ``output-u.wav`` and ``string_params.npz``.
    ``plot`` draws ``eval_f0.pdf`` and ``eval_f0_hsv.png`` beside it."""
    if plot:
        uplot.require()
    wav_path = os.path.join(sim_dir, "output-u.wav")
    str_path = os.path.join(sim_dir, "string_params.npz")
    if not (os.path.exists(wav_path) and os.path.exists(str_path)):
        return None
    wav, wsr = wavio.read(wav_path)
    params = np.load(str_path)
    f0_in = np.atleast_1d(params["f0"])
    f0_tgt = np.atleast_1d(params["target_f0"])
    kappa = float(np.atleast_1d(params["kappa"])[0])

    # the Fletcher-theory sounding frequency of the simulation's input
    mode1 = fdm.stiff_string_modes(f0_in.mean(), kappa, 1)[0][0]

    f0_est = compute_harmonic_parameters(wav, wsr)["f0"]
    voiced = f0_est > 0
    est = float(np.median(f0_est[voiced])) if voiced.any() else 0.0

    u0 = np.atleast_2d(params["u0"])[0]
    scores = {
        "f0_estimate": est,
        "f0_input_mean": float(f0_in.mean()),
        "f0_target_mean": float(f0_tgt.mean()),
        "f0_mode_pred": float(np.asarray(mode1).mean()),
        "abs_diff_input": abs(est - float(f0_in.mean())),
        "abs_diff_target": abs(est - float(f0_tgt.mean())),
        "abs_diff_modes": abs(est - float(np.asarray(mode1).mean())),
        "rde_target_pct": float(relative_detune_error(est, float(f0_tgt.mean()))),
        # the sampled parameters, the columns of the summary's scatter panels
        "kappa": kappa,
        "alpha": float(np.atleast_1d(params["alpha"])[0]),
        "p_a": float(np.atleast_1d(params["p_a"])[0]),
        "p_x": float(np.argmax(u0) / max(len(u0) - 1, 1)),
    }
    with open(os.path.join(sim_dir, "string_params.txt"), "w") as f:
        for k, v in scores.items():
            f.write(f"{k}\t{v:.4f}\n")
    if plot:
        f0_overlay = f0_tgt if f0_tgt.ndim else None
        uplot.rainbowgram(os.path.join(sim_dir, "eval_f0.pdf"), wav, wsr,
                          f0_input=f0_overlay)
        # the reference's hsv, log-frequency variant with the tracked f0
        # (reference plot.py:325-394; evaluate.py:62-63)
        uplot.rainbowgram_hsv(os.path.join(sim_dir, "eval_f0_hsv.png"), wav, wsr,
                              f0_input=f0_overlay, f0_estimate=f0_est)
    return scores


def evaluate(load_dir, sr=48000, plot=False):
    """Score every item directory of ``load_dir`` and write
    ``evaluation.txt`` (one row per item); with ``plot`` (which needs
    matplotlib) the items' figures and the run's ``detune_scatter.pdf`` and
    ``detune_kappa.pdf``.  Returns ``[(item, scores)]``."""
    if plot:
        uplot.require()
    dirs = sorted(
        d for d in glob.glob(f"{load_dir}/*") if os.path.isdir(d) and "codes" not in d
    )
    all_scores = []
    for d in dirs:
        s = evaluate_dir(d, sr, plot)
        if s is not None:
            all_scores.append((os.path.basename(d), s))
    if all_scores:
        keys = list(all_scores[0][1].keys())
        with open(os.path.join(load_dir, "evaluation.txt"), "w") as f:
            f.write("item\t" + "\t".join(keys) + "\n")
            for name, s in all_scores:
                f.write(name + "\t" + "\t".join(f"{s[k]:.4f}" for k in keys) + "\n")
        print(f"[evaluate] {len(all_scores)} items -> {load_dir}/evaluation.txt")
        if plot and len(all_scores) > 1:
            # scatter summaries over the sampled parameter space (reference
            # plot.py:682-820 scatter_pluck / scatter_kappa)
            def col(k):
                return np.array([s[k] for _, s in all_scores])

            detunes = {
                r"$|f_0^{(\tt est)} - f_0|$": col("abs_diff_input"),
                r"$|f_0^{(\tt est)} - \hat{f_0}|$": col("abs_diff_target"),
            }
            uplot.detune_scatter(os.path.join(load_dir, "detune_scatter.pdf"), detunes,
                                 col("kappa"), alpha=col("alpha"), p_x=col("p_x"),
                                 p_a=col("p_a"))
            uplot.scatter_kappa(os.path.join(load_dir, "detune_kappa.pdf"),
                                col("abs_diff_input"),
                                np.abs(col("f0_mode_pred") - col("f0_input_mean")),
                                col("kappa"), alpha=col("alpha"))
    return all_scores
