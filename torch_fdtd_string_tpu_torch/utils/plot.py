"""Plots and the string-motion video (matplotlib; librosa- and ffmpeg-free).

Port of ``torch_fdtd_string_tpu/utils/plot.py`` (reference
``src/utils/plot.py``): the artifact set the tasks draw, spectrogram
"rainbowgram" panels, f0 overlays, phase diagrams, simulation parameter
panels, the state-field and detune summaries, the time-scaling figure, and
the string-motion video (mp4 through ffmpeg when it is on ``PATH``, else
``string_state.npz`` and the frames).  Host numpy and matplotlib (Agg).

Matplotlib is imported by each drawing call, not with this module, so the
package imports on a host without it; an entry point asked to draw calls
:func:`require` before any work, which raises an ``ImportError`` naming the
option that turns the figures off.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from .audio import stft_mag


def require(option="task.plot"):
    """Raise an ``ImportError`` naming ``option`` (the setting that asked
    for figures) when matplotlib cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as err:
        raise ImportError(
            f"{option}=true draws figures with matplotlib, which this host lacks; "
            f"pass {option}=false") from err


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def rainbowgram(path, wav, sr, f0_input=None, n_fft=1024, hop=256, colorbar=False):
    """Log-magnitude spectrogram with phase-derivative coloring
    (reference plot.py:325-394's role)."""
    plt = pyplot()
    wav = np.asarray(wav, np.float64)
    window = np.hanning(n_fft)
    pad = n_fft // 2
    xp = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(xp[idx] * window, axis=-1)
    mag = np.abs(spec).T
    phase = np.unwrap(np.angle(spec), axis=0).T
    dphase = np.diff(phase, axis=1, prepend=phase[:, :1])

    fig, ax = plt.subplots(figsize=(6, 4))
    logmag = 20 * np.log10(mag + 1e-8)
    extent = [0, len(wav) / sr, 0, sr / 2]
    im = ax.imshow(
        logmag,
        origin="lower",
        aspect="auto",
        extent=extent,
        cmap="magma",
        vmin=logmag.max() - 100,
        vmax=logmag.max(),
    )
    ax.imshow(
        dphase,
        origin="lower",
        aspect="auto",
        extent=extent,
        cmap="rainbow",
        alpha=0.25,
    )
    if f0_input is not None:
        t = np.linspace(0, len(wav) / sr, len(np.atleast_1d(f0_input)))
        ax.plot(t, np.atleast_1d(f0_input), "w--", lw=0.8, label="input f0")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_ylim(0, min(4 * float(np.max(f0_input)) + 200, sr / 2))
    if colorbar:
        fig.colorbar(im, ax=ax)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("freq (Hz)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def rainbowgram_hsv(path, wav, sr, f0_input=None, f0_estimate=None,
                    modes=None, colorbar=True, n_fft=None):
    """Reference-style rainbowgram (reference plot.py:325-394): hsv-colored
    demodulated phase derivative with dB-magnitude alpha on a log-frequency
    axis, black background, white overlays for f0 input/estimate and mode
    trajectories.  Self-written STFT/display (no librosa).
    """
    plt = pyplot()
    wav = np.asarray(wav, np.float64)
    L = 32
    if n_fft is None:
        n_fft = 2**13 if wav.shape[-1] > 2 * 2**13 else wav.shape[-1] // 2
    hop = max(n_fft // L, 1)
    rms = np.sqrt(np.mean(wav**2)) + 1e-12
    w = wav / rms * 10 ** (-24 / 20)  # rms_normalize twin (-24 dB default)

    window = np.hanning(n_fft)
    pad = n_fft // 2
    xp = np.pad(w, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    D = np.fft.rfft(xp[idx] * window, axis=-1).T  # (freq, time)
    mag = np.abs(D)

    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    times = np.arange(n_frames) * hop / sr
    t_max = wav.shape[-1] / sr

    # demodulate each bin by its expected phase advance, then the scaled
    # unwrapped time-derivative is the instantaneous-frequency deviation
    phase_exp = 2 * np.pi * np.multiply.outer(freqs, times)
    unwrapped = np.unwrap((np.angle(D) - phase_exp) / (L / 4), axis=1)
    dphase = np.diff(unwrapped, axis=1, prepend=0)

    db = 20 * np.log10(mag / (mag.max() + 1e-30) + 1e-30)
    alpha = np.clip(db / 80.0 + 1.0, 0.0, 1.0)

    fig, ax = plt.subplots(figsize=(7, 7))
    cmap = plt.get_cmap("hsv")
    rgba = cmap((dphase + np.pi) / (2 * np.pi))
    rgba[..., -1] = alpha
    ax.imshow(
        rgba[1:], origin="lower", aspect="auto",
        extent=[0, times[-1] if len(times) > 1 else t_max,
                freqs[1], freqs[-1]],
        interpolation="nearest",
    )
    ax.set_yscale("log")
    ax.set_ylim(max(freqs[1], 16.0), sr / 2)
    ax.set_facecolor("#000")
    if colorbar:
        import matplotlib.cm as mcm
        from matplotlib.colors import Normalize

        sm = mcm.ScalarMappable(Normalize(-np.pi, np.pi), cmap)
        cbar = fig.colorbar(
            sm, ticks=[-np.pi, -np.pi / 2, 0, np.pi / 2, np.pi], ax=ax
        )
        cbar.ax.set(yticklabels=[r"$-\pi$", r"$-\pi/2$", "$0$",
                                 r"$\pi/2$", r"$\pi$"])

    def add_plot(f, dashes):
        f = np.atleast_1d(np.asarray(f, np.float64))
        x = np.linspace(1 / sr, t_max, f.shape[-1])
        fi = np.interp(times, x, f)
        (line,) = ax.plot(times, fi, color="white", lw=2.0)
        line.set_dashes(dashes)
        return line

    if f0_input is not None:
        add_plot(f0_input, (10, 5))
    if f0_estimate is not None:
        add_plot(f0_estimate, (2, 5))
    if modes is not None:
        for m in modes:
            add_plot(m, (5, 10, 1, 10))
    ax.xaxis.set_visible(False)
    ax.yaxis.set_visible(False)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight", facecolor="black")
    plt.close(fig)


def phase_diagram(path, wav, sr, tau=1, label=r"$u$"):
    """(u, du/dt) phase portrait (reference plot.py:396+)."""
    plt = pyplot()
    wav = np.asarray(wav, np.float64)
    d = (wav[tau:] - wav[:-tau]) / (tau / sr)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(wav[:-tau], d, lw=0.2)
    ax.set_xlabel(label)
    ax.set_ylabel(f"d{label}/dt")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def simulation_plots(directory, uout, zout, target_f0, sr):
    """Spec + f0 + phase panels for one simulated item (simulate.py:440-447)."""
    os.makedirs(directory, exist_ok=True)
    rainbowgram(f"{directory}/spec.pdf", uout, sr)
    rainbowgram(f"{directory}/f0.pdf", uout, sr, f0_input=target_f0)
    wout = uout + zout
    phase_diagram(f"{directory}/phs.pdf", wout, sr, label=r"$\xi$")
    phase_diagram(f"{directory}/phs-u.pdf", uout, sr, label="$u$")
    phase_diagram(f"{directory}/phs-z.pdf", zout, sr, label=r"$\zeta$")


def _hard_bow(v, a, eps):
    """Friction curve (bow.cpp:10-12) for the diagnostic panels."""
    return np.sign(v) * (eps + (1.0 - eps) * np.exp(-a * np.abs(v)))


def simulation_data(directory, uout, zout, v_r_out, F_H_out, u_H_out,
                    state_u, state_z, string_params, bow_params,
                    hammer_params, sr=48000, **extra):
    """Per-item parameter/diagnostic panels (reference plot.py:84-217):
    ``string.png`` (f0 trajectory, final transverse/longitudinal states with
    pickup & bow markers, output waveforms), ``bow.png`` (bowing controls,
    friction curve, relative-velocity attack/release), ``bow-velforce.pdf``
    (measured friction coefficient over the theoretical curve) and
    ``hammer.png`` (contact displacement/force over the first 8 ms)."""
    plt = pyplot()
    os.makedirs(directory, exist_ok=True)
    kappa, alpha, u0, v0, p_a, f0, pos, T60, target_f0 = string_params
    x_b, v_b, F_b, phi_0, phi_1, wid_b = bow_params
    x_H, v_H, u_H, w_H, M_r, alpha_H = hammer_params
    uout = np.asarray(uout)
    zout = np.asarray(zout)
    N = min(1000, len(uout))
    max_disp = np.abs(uout[:N]).max() + 1e-12

    # ---- string.png ------------------------------------------------------
    fig, ax = plt.subplots(figsize=(7, 7), nrows=5, ncols=1)
    ax[0].plot(np.atleast_1d(f0), "k-")
    ax[0].set_ylabel("f0")
    ax[0].set_ylim([0, max(500.0, 1.2 * float(np.max(f0)))])
    for i, (st, name) in enumerate(
        ((state_u, "transverse state"), (state_z, "longitudinal state")), 1
    ):
        if st is not None and len(st):
            ax[i].plot(np.linspace(0, 1, st.shape[-1]), st[-1], "k-")
        ax[i].axvline(x=float(np.atleast_1d(pos)[0]), c="r", lw=0.5)
        ax[i].axvline(x=float(np.atleast_1d(x_b)[-1]), c="b", lw=0.5)
        ax[i].set_ylabel(name)
    ax[3].plot(uout[:N], "k-")
    ax[3].set_ylabel("output u")
    ax[3].set_ylim([-max_disp, max_disp])
    ax[4].plot(zout[:N], "k-")
    ax[4].set_ylabel("output z")
    for a_ in ax:
        a_.yaxis.tick_right()
        a_.axhline(y=0, c="k", lw=0.5)
    fig.tight_layout()
    fig.savefig(f"{directory}/string.png", dpi=110)
    plt.close(fig)

    # ---- bow.png ---------------------------------------------------------
    phi0f = float(np.atleast_1d(phi_0)[0])
    phi1f = float(np.atleast_1d(phi_1)[0])
    rels = np.linspace(-1, 1, 100)
    v_r_out = np.asarray(v_r_out)
    fig, ax = plt.subplots(figsize=(7, 7), nrows=3, ncols=2)
    panels = [
        (ax[0, 0], np.atleast_1d(x_b), "bowing position", (0, 1)),
        (ax[1, 0], np.atleast_1d(v_b), "bowing velocity", (0, 0.5)),
        (ax[2, 0], np.atleast_1d(F_b), "bowing force", (0, 100)),
        (ax[0, 1], _hard_bow(rels, phi0f, phi1f), "bow friction fn", (-1.5, 1.5)),
        (ax[1, 1], v_r_out[:N], "rel vel (attack)", (-2, 2)),
        (ax[2, 1], v_r_out[-N:], "rel vel (release)", (-2, 2)),
    ]
    for a_, y, label, ylim in panels:
        a_.plot(rels if label == "bow friction fn" else np.arange(len(y)), y, "k-")
        a_.axhline(y=0, c="k", lw=0.5)
        a_.set_ylabel(label)
        a_.yaxis.tick_right()
        a_.set_ylim(list(ylim))
    fig.tight_layout()
    fig.savefig(f"{directory}/bow.png", dpi=110)
    plt.close(fig)

    # ---- bow-velforce.pdf: measured friction coefficient -----------------
    Nt = len(v_r_out)
    if Nt > 1:
        Nx = state_u.shape[-1] if state_u is not None else 1
        a_f = (v_r_out[1:] - v_r_out[:-1]) * sr
        Fb1 = np.atleast_1d(F_b)
        # align the (Nt-2)-long probe trace with the Nt-long control signal
        F_bv = (np.full(Nt - 1, Fb1[0]) if Fb1.size == 1
                else Fb1[-(Nt - 1):] if Fb1.size >= Nt - 1
                else np.pad(Fb1, (0, Nt - 1 - Fb1.size), mode="edge"))
        mu = a_f / Nx / np.where(F_bv != 0, F_bv, 1.0)
        vr = v_r_out[:-1]
        rels2 = np.linspace(vr.min() - 0.1, vr.max() + 0.1, 100)
        fig, a_ = plt.subplots(figsize=(4, 4))
        a_.fill_between(rels2, _hard_bow(rels2, phi0f, phi1f), alpha=0.2,
                        facecolor="r")
        a_.plot(vr, mu, "k-", lw=0.5)
        a_.axhline(y=0, c="k", lw=0.5)
        a_.set_xlabel("Relative velocity")
        a_.set_ylabel("Friction coefficient")
        a_.set_ylim([-1.5, 1.5])
        fig.tight_layout()
        fig.savefig(f"{directory}/bow-velforce.pdf", dpi=110)
        plt.close(fig)

    # ---- hammer.png: first 8 ms of contact -------------------------------
    n8 = min(int(sr * 8e-3), len(np.asarray(u_H_out)))  # short runs < 8 ms
    tms = np.linspace(0, n8 / sr * 1e3, n8)
    fig, ax = plt.subplots(figsize=(7, 5), nrows=2, ncols=1)
    ax[0].plot(tms, np.asarray(u_H_out)[:n8], "k-")
    ax[0].set_ylabel("hammer displacement")
    ax[1].plot(tms, np.asarray(F_H_out)[:n8], "k-")
    ax[1].set_ylabel("hammer force")
    for a_ in ax:
        a_.axhline(y=0, c="k", lw=0.5)
        a_.yaxis.tick_right()
    fig.tight_layout()
    fig.savefig(f"{directory}/hammer.png", dpi=110)
    plt.close(fig)


def state_specs(save_path, analytic, estimate, simulate):
    """FDTD vs modal vs estimate state-field panel (reference
    plot.py:219-268): 3x2 grid of downsampled u(x, t) images, difference
    maps, and a center-point time-trace overlay."""
    plt = pyplot()
    analytic = np.asarray(analytic)
    estimate = np.asarray(estimate)
    simulate = np.asarray(simulate)
    tf = max(1, simulate.shape[0] // 100)
    nt = max(simulate.shape[0] // 100, 16)
    nx = simulate.shape[1] // 2
    diff_ana = analytic - simulate
    diff_est = estimate - simulate
    maxval = np.abs(simulate).max() + 1e-12
    maxerr = max(np.abs(diff_ana).max(), np.abs(diff_est).max()) + 1e-12

    fig, ax = plt.subplots(ncols=2, nrows=3, figsize=(7, 7))
    kw = dict(aspect="auto", origin="lower", cmap="coolwarm")
    for i, arr in enumerate((simulate, analytic, estimate)):
        ax[i, 0].imshow(arr[::tf].T, vmin=-maxval, vmax=maxval, **kw)
    ax[1, 1].imshow(diff_ana[::tf].T, vmin=-maxerr, vmax=maxerr, **kw)
    ax[2, 1].imshow(diff_est[::tf].T, vmin=-maxerr, vmax=maxerr, **kw)
    ax[0, 1].plot(simulate[:nt, nx], c="goldenrod", label="FDTD")
    ax[0, 1].plot(analytic[:nt, nx], c="r", label="Modal")
    ax[0, 1].plot(estimate[:nt, nx], c="g", label="Ours")
    ax[0, 1].legend(fontsize=7, loc="upper right")
    for i, title in enumerate(["FDTD", "Modal", "Ours"]):
        ax[i, 0].set_ylabel(title)
    for a_ in ax.ravel():
        a_.set_xticks([])
        a_.set_yticks([])
    fig.tight_layout()
    fig.subplots_adjust(wspace=0, hspace=0)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def est_tar_specs(save_dir, est_wavs, tar_wavs, inp_wavs, sr, prefix="item"):
    """Estimate/target/analytic log-mag + log-mel spectrogram tables
    (reference plot.py:926-1034's role; files instead of wandb tables)."""
    plt = pyplot()
    from .audio import mel_filterbank

    os.makedirs(save_dir, exist_ok=True)
    est_wavs = np.asarray(est_wavs)
    tar_wavs = np.asarray(tar_wavs)
    inp_wavs = np.asarray(inp_wavs) if inp_wavs is not None else None
    n_fft, hop = 1024, 256
    mel = mel_filterbank(sr, n_fft, 128)

    def specs(w):
        m = np.asarray(stft_mag(w[None], n_fft, hop))[0].T  # (bins, frames)
        logmag = 20 * np.log10(m + 1e-5)
        logmel = 20 * np.log10(mel @ m + 1e-5)
        return logmag, logmel

    paths = []
    for b in range(len(est_wavs)):
        rows = [("Estimate", est_wavs[b]), ("Original", tar_wavs[b])]
        if inp_wavs is not None:
            rows.insert(0, ("Analytic", inp_wavs[b]))
        fig, ax = plt.subplots(len(rows) + 1, 2, figsize=(7, 2 * len(rows) + 2))
        sp = {name: specs(w) for name, w in rows}
        for i, (name, _) in enumerate(rows):
            for j in range(2):
                ax[i, j].imshow(sp[name][j], aspect="auto", origin="lower",
                                cmap="magma", vmin=-60, vmax=30)
            ax[i, 0].set_ylabel(name)
        d_mag = sp["Original"][0] - sp["Estimate"][0]
        d_mel = sp["Original"][1] - sp["Estimate"][1]
        for j, d in enumerate((d_mag, d_mel)):
            ax[-1, j].imshow(d, aspect="auto", origin="lower", cmap="bwr",
                             vmin=-20, vmax=20)
        ax[-1, 0].set_ylabel("Difference")
        for a_ in ax.ravel():
            a_.set_xticks([])
            a_.set_yticks([])
        fig.tight_layout()
        fig.subplots_adjust(wspace=0, hspace=0)
        path = os.path.join(save_dir, f"{prefix}{b}_specs.png")
        fig.savefig(path, bbox_inches="tight", dpi=110)
        plt.close(fig)
        paths.append(path)
    return paths


def detune_scatter(save_path, detunes, kappa, alpha=None, p_x=None, p_a=None):
    """f0-detune scatter summaries over the sampled parameter space
    (reference plot.py:682-820 ``scatter_kappa``/``scatter_pluck`` role).

    ``detunes``: dict label -> (N,) |f0 error| in Hz; panels per available
    parameter axis."""
    plt = pyplot()
    axes_spec = [("$\\kappa$", kappa)]
    if alpha is not None:
        axes_spec.append(("$\\alpha$", alpha))
    if p_x is not None:
        axes_spec.append(("$p_x$", p_x))
    if p_a is not None:
        axes_spec.append(("$p_a$", p_a))
    fig, ax = plt.subplots(1, len(axes_spec), figsize=(2.2 * len(axes_spec), 2.4))
    ax = np.atleast_1d(ax)
    colors = ["orchid", "cadetblue", "goldenrod"]
    ymax = max(np.max(v) for v in detunes.values()) + 3.0
    for j, (label, x) in enumerate(axes_spec):
        for ci, (name, y) in enumerate(detunes.items()):
            ax[j].scatter(x, y, s=2.0, alpha=0.7, c=colors[ci % 3],
                          label=name if j == 0 else None)
        ax[j].set_xlabel(label)
        ax[j].set_ylim([0, ymax])
        ax[j].xaxis.tick_top()
        if j:
            ax[j].set_yticks([])
    ax[0].set_ylabel("Detune (Hz)")
    fig.legend(fontsize=6, loc="lower center", ncol=len(detunes))
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight", transparent=True, dpi=120)
    plt.close(fig)


def state_video(directory, state_u, sr, fps=30, trim_front=False, max_frames=240):
    """String-motion animation (reference plot.py:270-323).

    Renders frames with matplotlib and assembles an mp4 via ffmpeg when
    available; always saves ``string_state.npz`` for offline inspection.
    """
    plt = pyplot()
    os.makedirs(directory, exist_ok=True)
    state_u = np.asarray(state_u)
    np.savez_compressed(f"{directory}/string_state.npz", state_u=state_u)

    if trim_front:
        state_u = state_u[2:]
    stride = max(1, len(state_u) // max_frames)
    frames = state_u[::stride]
    vmax = np.abs(state_u).max() + 1e-12

    tmp = f"{directory}/_frames"
    os.makedirs(tmp, exist_ok=True)
    for i, row in enumerate(frames):
        fig, ax = plt.subplots(figsize=(5, 2.2))
        ax.plot(row)
        ax.set_ylim(-vmax, vmax)
        ax.set_title(f"t = {i * stride / sr:.3f}s")
        fig.tight_layout()
        fig.savefig(f"{tmp}/{i:05d}.png", dpi=80)
        plt.close(fig)
    if shutil.which("ffmpeg"):
        subprocess.run(
            [
                "ffmpeg",
                "-y",
                "-loglevel",
                "quiet",
                "-framerate",
                str(fps),
                "-i",
                f"{tmp}/%05d.png",
                "-pix_fmt",
                "yuv420p",
                f"{directory}/string_state.mp4",
            ],
            check=False,
        )
        shutil.rmtree(tmp, ignore_errors=True)


def time_scaling_figure(path, results):
    """The time sweep's scaling curves (reference plot.py:821-923's role),
    each relative to its first point.

    ``results``: dict axis_name -> dict curve label -> list of (x, seconds).
    """
    plt = pyplot()
    fig, axes = plt.subplots(1, len(results), figsize=(4 * len(results), 3))
    if len(results) == 1:
        axes = [axes]
    for ax, (name, curves) in zip(axes, results.items()):
        for label, pts in curves.items():
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            ys = [y / ys[0] for y in ys]
            ax.plot(xs, ys, marker="o", label=label)
        ax.set_xlabel(name)
        ax.set_ylabel("relative time")
        ax.set_xscale("log")
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def scatter_kappa(save_path, f0_diffs, f0_ground, kappa, alpha=None):
    """Detune-vs-stiffness scatter with Fletcher-prediction overlay
    (reference plot.py:699-744): |f0_est - f0| against kappa, colored by
    alpha, with the sorted Fletcher ground-shift curve underneath."""
    plt = pyplot()
    f0_diffs = np.asarray(f0_diffs, float)
    kappa = np.asarray(kappa, float)
    fig, ax = plt.subplots(figsize=(2.8, 2.2))
    if f0_ground is not None:
        order = np.argsort(kappa)
        sk = kappa[order][::max(len(kappa) // 24, 1)]
        sf = np.asarray(f0_ground, float)[order][::max(len(kappa) // 24, 1)]
        ax.plot(sk, sf, "k-", lw=1.0, alpha=0.5)
    if alpha is not None:
        sc = ax.scatter(kappa, f0_diffs, c=np.asarray(alpha, float), s=3.0,
                        cmap="plasma")
        cbar = fig.colorbar(sc)
        cbar.ax.set_title(r"$\alpha$", fontsize=8)
    else:
        ax.scatter(kappa, f0_diffs, s=3.0, c="orchid")
    ax.set_xlabel(r"$\kappa$")
    ax.set_ylabel(r"$|f_0^{(\tt est)} - f_0|$ (Hz)")
    ax.xaxis.tick_top()
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight", transparent=True, dpi=120)
    plt.close(fig)


def rde_specs(save_dir, factors, est, sim, sr, state_ms=30.0):
    """Relative-detune-experiment artifact set (reference plot.py:1005-1135
    + callbacks.PlotRDE, files instead of wandb tables).

    ``est``/``sim``: dicts with ``wav`` (list of (Nt,) arrays, one per
    factor) and optional ``state`` (list of (Nt, Nx, 2) u/z fields).
    Writes rde-mag.png / rde-mel.png, rde-state-{pinn,fdtd}-{u,z}.png,
    per-factor wav pairs and an ``rde.txt`` RDE table; returns the path
    list."""
    plt = pyplot()
    from .audio import mel_filterbank
    from .frequency import compute_harmonic_parameters
    from .vnv import relative_detune_error

    os.makedirs(save_dir, exist_ok=True)
    n = len(factors)
    n_fft, hop = 1024, 256
    mel = mel_filterbank(sr, n_fft, 128)

    def logspecs(w):
        m = np.asarray(stft_mag(np.asarray(w)[None], n_fft, hop))[0].T
        return 20 * np.log10(m + 1e-5), 20 * np.log10(mel @ m + 1e-5)

    # one STFT per wav, reused across the mag and mel figures
    sim_ls = [logspecs(sim["wav"][i]) for i in range(n)]
    est_ls = [logspecs(est["wav"][i]) for i in range(n)]

    paths = []
    for which, key in (("mag", 0), ("mel", 1)):
        fig, ax = plt.subplots(n, 2, figsize=(5, 1.4 * n), squeeze=False)
        for i in range(n):
            ax[i, 0].imshow(sim_ls[i][key], aspect="auto",
                            origin="lower", cmap="magma", vmin=-60, vmax=30)
            ax[i, 1].imshow(est_ls[i][key], aspect="auto",
                            origin="lower", cmap="magma", vmin=-60, vmax=30)
            ax[i, 0].set_ylabel(rf"$x\times{factors[i]}$")
            for j in (0, 1):
                ax[i, j].set_xticks([]), ax[i, j].set_yticks([])
        ax[0, 0].set_title("FDTD")
        ax[0, 1].set_title("PINN")
        fig.tight_layout()
        fig.subplots_adjust(wspace=0, hspace=0)
        p = os.path.join(save_dir, f"rde-{which}.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)

    if est.get("state") is not None and sim.get("state") is not None:
        Nt = int(sr * state_ms / 1000)
        for src, tag in ((sim, "fdtd"), (est, "pinn")):
            for comp, cname in ((0, "u"), (1, "z")):
                fig, ax = plt.subplots(n, 2, figsize=(7, 1.4 * n),
                                       squeeze=False)
                smax = max(
                    float(np.abs(np.asarray(s)[:Nt, :, comp]).max())
                    for s in src["state"]
                ) or 1.0
                for i in range(n):
                    s_i = np.asarray(src["state"][i])[:Nt, :, comp]
                    d_i = s_i - np.asarray(src["state"][-1])[:Nt, :, comp]
                    ax[i, 0].imshow(s_i.T, aspect="auto", cmap="coolwarm",
                                    vmin=-smax, vmax=smax)
                    ax[i, 1].imshow(d_i.T, aspect="auto", cmap="coolwarm",
                                    vmin=-smax / 10, vmax=smax / 10)
                    ax[i, 0].set_ylabel(rf"$x\times{factors[i]}$")
                    for j in (0, 1):
                        ax[i, j].set_xticks([]), ax[i, j].set_yticks([])
                fig.tight_layout()
                fig.subplots_adjust(wspace=0, hspace=0)
                p = os.path.join(save_dir, f"rde-state-{tag}-{cname}.png")
                fig.savefig(p, dpi=110)
                plt.close(fig)
                paths.append(p)

    from . import wav as wavio

    rows = []
    for i, fc in enumerate(factors):
        fstr = f"{fc:.1f}".replace(".", "_")
        wavio.write(os.path.join(save_dir, f"rde-pinn-{fstr}.wav"),
                    np.asarray(est["wav"][i]), sr, "PCM_16")
        wavio.write(os.path.join(save_dir, f"rde-fdtd-{fstr}.wav"),
                    np.asarray(sim["wav"][i]), sr, "PCM_16")

        def _f0(w):
            w = np.asarray(w, np.float64)
            w = w / (np.sqrt(np.mean(w**2)) + 1e-12)
            return float(np.median(compute_harmonic_parameters(w, sr)["f0"]))

        rows.append(
            (fc, float(relative_detune_error(_f0(est["wav"][i]),
                                             _f0(sim["wav"][i]))))
        )
    table = os.path.join(save_dir, "rde.txt")
    with open(table, "w") as f:
        f.write("factor\trde_percent\n")
        for fc, v in rows:
            f.write(f"{fc}\t{v:.6f}\n")
    paths.append(table)
    return paths
