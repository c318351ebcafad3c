"""Training and evaluation artifact writers.

Port of ``torch_fdtd_string_tpu/tasks/callbacks.py`` (reference
``src/callbacks.py``: ``PlotResults``, ``SaveTestResults``,
``PlotStateVideo``, ``SaveResults``): the plot panels of a validation
batch, the score tables, the estimate / analytic / FDTD state summary
and video of a test string, and the test waves, as plain files under the
run directory (matplotlib for the figures, ``utils/plot.py``).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ..utils import plot as uplot
from ..utils import wav as wavio


def plot_results(save_dir, split, outputs, sr, n_items=4, step=0):
    """Spectrogram + waveform panels for a batch (reference
    callbacks.py:14-97 ``PlotResults``)."""
    plt = uplot.pyplot()
    d = os.path.join(save_dir, "plots", f"{split}_{step}")
    os.makedirs(d, exist_ok=True)
    preds = np.asarray(outputs["preds"])
    target = np.asarray(outputs["target"])
    n = min(n_items, len(preds))
    for i in range(n):
        fig, axes = plt.subplots(2, 2, figsize=(9, 5))
        t = np.arange(preds.shape[-1]) / sr
        axes[0, 0].plot(t, target[i], lw=0.3)
        axes[0, 0].set_title("target")
        axes[0, 1].plot(t, preds[i], lw=0.3)
        axes[0, 1].set_title("estimate")
        for j, sig in enumerate((target[i], preds[i])):
            spec = np.abs(np.fft.rfft(sig * np.hanning(len(sig))))
            axes[1, j].semilogy(
                np.fft.rfftfreq(len(sig), 1 / sr), spec + 1e-9, lw=0.4
            )
            axes[1, j].set_xlim(0, 4000)
        fig.tight_layout()
        fig.savefig(os.path.join(d, f"item{i}.png"), dpi=100)
        plt.close(fig)
        wavio.write(os.path.join(d, f"item{i}_est.wav"), preds[i], sr)
        wavio.write(os.path.join(d, f"item{i}_tgt.wav"), target[i], sr)
    if preds.shape[-1] >= 2048:
        # estimate/target logmag+logmel spec tables (reference
        # callbacks.py:88 -> plot.est_tar_specs wandb table, as files)
        uplot.est_tar_specs(d, preds[:n], target[:n],
                      np.asarray(outputs["analytic"])[:n]
                      if "analytic" in outputs else None, sr)
    return d


def save_test_results(save_dir, rows, header, name="output", ids=None, partial=False):
    """Score TSVs (reference callbacks.py:99-135 ``SaveTestResults``): one
    ``id``-keyed row per test item plus a trailing mean row.

    ``partial=True`` marks a mid-scoring flush: the table gets a
    ``# partial`` trailer instead of the mean row, so that no consumer
    mistakes a prefix of the test split for final scores.  Writes are
    atomic (temporary file + ``os.replace``).
    """
    d = os.path.join(save_dir, "score")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.txt")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\t".join(["id"] + list(header)) + "\n")
        for i, r in enumerate(rows):
            rid = ids[i] if ids else str(i)
            f.write("\t".join([rid] + [f"{v:.8f}" for v in r]) + "\n")
        if partial:
            f.write(f"# partial {len(rows)} rows (scoring incomplete)\n")
        elif rows:
            mean = np.mean(np.asarray(rows), axis=0)
            f.write("\t".join(["# mean"] + [f"{v:.8f}" for v in mean]) + "\n")
    os.replace(tmp, path)
    return path


def plot_state_video(save_dir, estimate_states, analytic_states, fdtd_states,
                     sr, name="state"):
    """Estimate vs analytic vs FDTD string-state summary (reference
    callbacks.py:137-179 ``PlotStateVideo.summary``): npz bundle, state-spec
    comparison panel, per-stream wav + rainbowgram, and the animation.

    Each argument: (Nt, Nx) or None.
    """
    plt = uplot.pyplot()
    os.makedirs(save_dir, exist_ok=True)
    arrays = {
        "estimate": estimate_states,
        "analytic": analytic_states,
        "fdtd": fdtd_states,
    }
    arrays = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    np.savez_compressed(os.path.join(save_dir, f"{name}.npz"), **arrays)
    if len(arrays) == 3:
        uplot.state_specs(
            os.path.join(save_dir, f"{name}.pdf"),
            arrays["analytic"], arrays["estimate"], arrays["fdtd"],
        )
    for label, v in arrays.items():
        wav = v.mean(-1)
        wavio.write(os.path.join(save_dir, f"{name}-{label}.wav"), wav, sr)
        if len(wav) >= 2048:  # rainbowgram needs at least a few STFT frames
            uplot.rainbowgram(
                os.path.join(save_dir, f"{name}-{label}.pdf"), wav, sr
            )

    some = next(iter(arrays.values()))
    stride = max(1, len(some) // 120)
    vmax = max(np.abs(v).max() for v in arrays.values()) + 1e-12
    frames_dir = os.path.join(save_dir, "_frames")
    os.makedirs(frames_dir, exist_ok=True)
    for fi, t in enumerate(range(0, len(some), stride)):
        fig, ax = plt.subplots(figsize=(5, 2.4))
        for label, v in arrays.items():
            ax.plot(v[t], lw=0.8, label=label)
        ax.set_ylim(-vmax, vmax)
        ax.legend(fontsize=6, loc="upper right")
        ax.set_title(f"t = {t / sr:.3f}s")
        fig.tight_layout()
        fig.savefig(os.path.join(frames_dir, f"{fi:05d}.png"), dpi=80)
        plt.close(fig)
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "quiet", "-framerate", "24",
             "-i", f"{frames_dir}/%05d.png", "-pix_fmt", "yuv420p",
             os.path.join(save_dir, f"{name}.mp4")],
            check=False,
        )
        shutil.rmtree(frames_dir, ignore_errors=True)


def save_results(save_dir, wavs, sr, ids=None, prefix=""):
    """SaveResults twin (reference callbacks.py:259-279): every test output
    wave under ``<save_dir>/wave/`` as PCM_16."""
    wdir = os.path.join(save_dir, "wave")
    os.makedirs(wdir, exist_ok=True)
    wavs = np.asarray(wavs)
    paths = []
    for i in range(len(wavs)):
        name = ids[i] if ids is not None else f"{prefix}{i}"
        p = os.path.join(wdir, f"{name}.wav")
        wavio.write(p, wavs[i], sr, "PCM_16")
        paths.append(p)
    return paths
