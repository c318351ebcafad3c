"""Dataset post-processing of the fused simulate->dataset path.

Port of ``torch_fdtd_string_tpu/ops/postproc.py``.  The state field the
string kernel collects on the device is consumed there, so that only the
training-grid arrays cross to the host:

* :func:`postprocess_batch` spline-upsamples each string's state rows from
  their live width to the kept training-grid columns (one ``bmm`` per width
  group against a stack of spline operators), forms the summed-velocity
  track, the live-domain max and a YIN pitch track, in plain PyTorch on the
  state's device, in float32 with no TF32;
* :func:`yin_track` is the batched twin of ``utils/frequency.py::track_f0``;
* :func:`spline_operator_stack`, :func:`host_widths_spread` and
  :func:`modal_target_host` stay host numpy, as in the JAX package.

Reference parity: spline upsample ``process_training_data.py:136-149``,
summed-velocity wav ``audio.py:108-113``, YIN as ``utils/frequency.py``.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from . import fdm


# ---------------------------------------------------------------------------
# batched YIN (difference function + CMNDF + parabolic interp + median-3)
# ---------------------------------------------------------------------------

def yin_track(wav, sr, hop_s=0.01, frame_s=0.064, fmin=32.0, fmax=2000.0,
              threshold=0.1, smooth=3):
    """Frame-wise YIN pitch track, batched: ``wav (B, Nt) -> (B, n_frames)``
    in ``wav``'s dtype and device.

    The algorithm and constants of ``utils/frequency.py::track_f0`` as
    fixed-shape tensor ops: difference function via Wiener-Khinchin,
    cumulative-mean normalisation, first dip under the threshold walked to
    its local minimum, subharmonic guard, parabolic refinement, median-3,
    then the spectral refinement gated to ±3%.
    """
    B, Nt = wav.shape
    dev, dt = wav.device, wav.dtype
    hop = int(sr * hop_s)
    frame = int(sr * frame_s)
    n_frames = max(1, Nt // hop + 1)
    pad = frame // 2
    x = torch.nn.functional.pad(wav, (pad, pad + frame))
    fr = x.unfold(1, frame, hop)[:, :n_frames]  # (B, F, n), a view
    silent = fr.abs().amax(dim=-1) < 1e-8

    tau_max = min(int(sr / fmin), frame - 1)
    tau_min = max(int(sr / fmax), 1)

    w = fr - fr.mean(dim=-1, keepdim=True)
    f = torch.fft.rfft(w, 2 * frame)
    acf = torch.fft.irfft(f * torch.conj(f), 2 * frame)[..., : tau_max + 1]
    ar = torch.arange(tau_max + 1, device=dev)
    # exact truncated-window difference function:
    # d(tau) = E[0..n-tau-1] + E[tau..n-1] - 2 acf(tau)
    E = torch.cumsum(w * w, dim=-1)
    Etot = E[..., -1:]
    term1 = E[..., frame - 1 - ar]
    term2 = Etot - torch.cat([torch.zeros_like(Etot), E[..., :tau_max]], dim=-1)
    d = (term1 + term2 - 2.0 * acf) * (frame / (frame - ar)).to(dt)
    d[..., 0] = 0.0
    cum = torch.cumsum(d[..., 1:], dim=-1)
    cmndf = torch.cat(
        [torch.ones_like(Etot),
         d[..., 1:] * ar[1:].to(dt) / torch.where(cum == 0, torch.ones_like(cum), cum)],
        dim=-1,
    )

    valid = (ar >= tau_min) & (ar < tau_max)
    below = (cmndf < threshold) & valid
    any_below = below.any(dim=-1)
    first_t = torch.argmax(below.to(torch.uint8), dim=-1)
    # walk forward while strictly decreasing: stop at the first tau >=
    # first_t whose successor does not decrease
    cm_next = torch.cat([cmndf[..., 1:], torch.full_like(Etot, math.inf)], dim=-1)
    dec = (cm_next < cmndf) & ((ar + 1) < tau_max)
    stop = (~dec) & (ar >= first_t[..., None])
    walk_t = torch.argmax(stop.to(torch.uint8), dim=-1)
    fallback = torch.argmin(
        torch.where(valid, cmndf, torch.full_like(cmndf, math.inf)), dim=-1)
    tau_i = torch.where(any_below, walk_t, fallback)

    # subharmonic guard: prefer an equally deep dip at ~tau/2
    take_at = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]
    t2 = torch.clamp(tau_i // 2, 1, tau_max - 1)
    t2n = torch.stack([t2 - 1, t2, t2 + 1], dim=-1)
    t2 = t2 + torch.argmin(torch.gather(cmndf, -1, t2n), dim=-1) - 1
    cm_t2 = take_at(cmndf, t2)
    cm_ti = take_at(cmndf, tau_i)
    take = (t2 >= tau_min) & (cm_t2 < torch.clamp(1.15 * cm_ti, min=threshold))
    tau_i = torch.where(take, t2, tau_i)

    # parabolic interpolation of the RAW difference function around the dip
    at = lambda off: take_at(d, torch.clamp(tau_i + off, 0, tau_max))
    a, b, c = at(-1), at(0), at(1)
    denom = a - 2.0 * b + c
    inner = (tau_i >= 1) & (tau_i < tau_max) & (denom != 0)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    tau = tau_i.to(dt) + torch.where(inner, 0.5 * (a - c) / safe, torch.zeros_like(a))
    f0 = torch.where(tau > 0, sr / torch.where(tau > 0, tau, torch.ones_like(tau)),
                     torch.zeros_like(tau))
    f0 = torch.where(silent, torch.zeros_like(f0), f0)

    if smooth > 1 and n_frames >= smooth:
        # median-3 with zero edge padding (scipy.signal.medfilt semantics)
        fp = torch.nn.functional.pad(f0, (1, 1))
        f0 = torch.stack([fp[:, :-2], fp[:, 1:-1], fp[:, 2:]], dim=-1).median(dim=-1).values

    # spectral refinement: parabolic log-magnitude interpolation of the
    # Hann-spectrum peak nearest the YIN estimate, gated to ±3%
    pad_mult = 4
    win = torch.as_tensor(np.hanning(frame), dtype=dt, device=dev)
    nfft = pad_mult * frame
    mag = torch.fft.rfft(fr * win, nfft).abs()
    n_bins = nfft // 2 + 1
    k0 = torch.round(torch.clamp(f0, 0.0, sr / 2.0) * nfft / sr).to(torch.int64)
    k0 = torch.clamp(k0, 2, n_bins - 3)
    span = torch.arange(-pad_mult, pad_mult + 1, device=dev)
    cand = torch.clamp(k0[..., None] + span, 1, n_bins - 2)  # (B, F, 2p+1)
    kpk = take_at(cand, torch.argmax(torch.gather(mag, -1, cand), dim=-1))
    lm = lambda off: torch.log(take_at(mag, kpk + off) + 1e-30)
    la, lb, lc = lm(-1), lm(0), lm(1)
    den = la - 2.0 * lb + lc
    safe = torch.where(den == 0, torch.ones_like(den), den)
    delta = torch.where(den != 0, 0.5 * (la - lc) / safe, torch.zeros_like(den))
    delta = torch.clamp(delta, -0.5, 0.5)
    f_ref = (kpk.to(dt) + delta) * (sr / nfft)
    ok = (f0 > 0) & ((f_ref - f0).abs() < 0.03 * torch.clamp(f0, min=1e-9))
    return torch.where(ok, f_ref, f0)


# ---------------------------------------------------------------------------
# spline operator stack (host build, device apply)
# ---------------------------------------------------------------------------

_OSTACK_CACHE = {}
_OSTACK_LOCK = threading.Lock()


def spline_operator_stack(M, x_keep, n_grid=256, k=5):
    """(M+1, M, K+1) float32 stack of per-width spline operators.

    Row ``w`` resamples a live slice of ``w`` points (uniform on [0, 1]) to
    the ``K = len(x_keep)`` kept columns of the ``n_grid`` training grid,
    and its last column holds the ``n_grid``-column row sum, so
    ``state @ O[w]`` gives the kept columns and the full-grid spatial sum
    in one GEMM.  Zero past ``w``: lanes past the live width cannot leak
    through.  Built once per (M, keep, grid) from
    :func:`..utils.data.spline_matrix`.
    """
    from ..utils import data as udata

    key = (int(M), tuple(int(i) for i in x_keep), int(n_grid), int(k))
    with _OSTACK_LOCK:
        st = _OSTACK_CACHE.get(key)
    if st is None:
        K = len(x_keep)
        st = np.zeros((M + 1, M, K + 1), np.float32)
        for w in range(2, M + 1):
            S = udata.spline_matrix(w, n_grid, k)  # (n_grid, w)
            st[w, :w, :K] = S[np.asarray(x_keep)].T
            st[w, :w, K] = S.sum(axis=0)
        with _OSTACK_LOCK:
            st = _OSTACK_CACHE.setdefault(key, st)
    return st


# ---------------------------------------------------------------------------
# fused device postprocess
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in full float32 on CUDA for the duration."""
    if not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


@torch.inference_mode()
def postprocess_batch(su, u1_init, u2_init, f0_head, f0_t, kappa, O_stack,
                      *, k, theta_t, lambda_c, sr, G=32):
    """Consume the device state field into training-grid arrays.

    Args, float32 tensors on one device:
      su: (T, B, M) state rows for t = 2..Nt-1, as the string kernel
      collects them; u1_init/u2_init: (B, M) rows t=1 and t=0;
      f0_head: (B, 2) f0 at t=0, 1; f0_t: (B, >=T) the kernel's f0 signal;
      kappa: (B,); O_stack: (M+1, M, K+1) from :func:`spline_operator_stack`.

    Returns a dict of tensors on that device:
      ``ut_keep`` (B, Nt, K) f16, the kept training-grid columns;
      ``vt`` (B, Nt-1) f16, the first difference of the full-grid spatial
      sum (summed-velocity wav, ``state_to_wav`` with k=1), formed in f32;
      ``ut_f0`` (B, n_frames) f32, the YIN track of the RMS-normalised sum;
      ``umax`` (B,) f32, the live-domain max |u| (the gain source).

    Each row's width is ``N_t + 1`` from :func:`..ops.fdm.get_derived_vars`
    (the guarded floor); rows are grouped as ``w = wmin_b + g``.  The
    batch's width spread must be below ``G`` (the caller checks it on the
    host with :func:`host_widths_spread`); the loop runs only over the
    widths that occur.  ``su`` is read in place: the two initial rows are
    multiplied on their own, so no (B, Nt, M) copy is made.
    """
    T, B, M = su.shape
    dev = su.device
    f0_full = torch.cat([f0_head, f0_t[:, :T]], dim=1)  # (B, Nt)
    Nt = T + 2
    dv = fdm.get_derived_vars(f0_full, kappa[:, None], k, theta_t, lambda_c, 1.0)
    widths = torch.clamp(dv.N_t.to(torch.int64) + 1, 0, M)  # (B, Nt)
    wmin = widths.amin(dim=1)  # (B,)
    n_groups = int((widths.amax(dim=1) - wmin).amax()) + 1
    if n_groups > G:
        raise ValueError(f"width spread {n_groups - 1} >= G={G}")

    head = torch.stack([u2_init, u1_init], dim=1)  # (B, 2, M)
    body = su.permute(1, 0, 2)  # (B, T, M), a strided view
    Kp1 = O_stack.shape[-1]
    acc = torch.zeros((B, Nt, Kp1), dtype=torch.float32, device=dev)
    with _no_tf32():
        for g in range(n_groups):
            w = wmin + g  # (B,)
            Og = O_stack[torch.clamp(w, 0, M)]  # (B, M, K+1)
            mask = (widths == w[:, None])[..., None]  # (B, Nt, 1)
            for rows, x in ((slice(0, 2), head), (slice(2, Nt), body)):
                y = torch.bmm(x, Og)
                acc[:, rows] = torch.where(mask[:, rows], y, acc[:, rows])
    ut_keep = acc[..., : Kp1 - 1]
    uts = acc[..., Kp1 - 1]

    # live-domain max |u|, a block of time rows at a time
    lane = torch.arange(M, device=dev)
    umax = torch.zeros(B, dtype=torch.float32, device=dev)
    for t0 in range(0, Nt, 4096):
        t1 = min(t0 + 4096, Nt)
        rows = torch.cat([head[:, t0:t1], body[:, max(t0 - 2, 0) : t1 - 2]], dim=1)
        live = lane < widths[:, t0:t1, None]
        part = torch.where(live, rows.abs(), torch.zeros_like(rows))
        umax = torch.maximum(umax, part.amax(dim=(1, 2)))

    rms = torch.sqrt(torch.mean(uts * uts, dim=1, keepdim=True))
    un = uts / torch.where(rms == 0, torch.ones_like(rms), rms)
    return {
        "ut_keep": ut_keep.to(torch.float16),
        "vt": (uts[:, 1:] - uts[:, :-1]).to(torch.float16),
        "ut_f0": yin_track(un, sr),
        "umax": umax,
    }


def host_widths_spread(f0, kappa, k, theta_t, lambda_c, dtype=np.float32):
    """Largest per-string spread of the live width ``N_t + 1`` over the
    control signal, from the dtype-faithful host twin of the device width
    formula; ``spread < G`` here means the device group loop covers every
    width."""
    nx = np.stack([
        fdm.grid_widths_np(f0[b], float(kappa[b]), k, theta_t, lambda_c,
                           dtype=dtype)
        for b in range(f0.shape[0])
    ])
    w = nx.astype(np.int64) + 1
    return int((w.max(axis=1) - w.min(axis=1)).max())


# ---------------------------------------------------------------------------
# host-side modal target (exact f64 phase; tiny inputs, GEMM-contracted)
# ---------------------------------------------------------------------------

def modal_target_host(u0_256, f0, kappa, T60, Nt, sr, x_keep, strict=False,
                      synth=True):
    """Modal solution ``ua`` on the kept columns, plus mode data.

    The mode problem is solved from the initial condition on the host and
    synthesised with f64 phase accumulation (the stored baseline's phase
    matters to the test-time si-sdr comparison).

    u0_256: (n_grid,) initial profile on the full training grid.
    Returns (ua_keep (Nt, K) f32, uas (Nt,) f32, mode_freq (n,),
    mode_amps_keep (n, K), ua_f0 (n_frames,)); ``synth=False`` computes
    only the mode data and returns None for the synthesised fields.
    """
    from ..core import analytic
    from ..tasks.process_training_data import t60_to_sigma_tv
    from ..utils import data as udata
    from ..utils import frequency as ufreq

    Na = 1024
    n_grid = u0_256.shape[0]
    u0_a = u0_256 @ udata.spline_matrix(n_grid, Na, k=5).T
    _, mode_freq, mode_amps = analytic.lossy_stiff_string(
        u0_a, f0, float(kappa), T60, Nt, Na, sr, strict=strict,
        return_field=False
    )
    mode_amps = mode_amps @ udata.spline_matrix(Na, n_grid, k=5).T  # (n, 256)
    if not synth:
        return (None, None, mode_freq,
                mode_amps[:, np.asarray(x_keep)], None)

    omega = np.asarray(f0, np.float64) / sr * (2 * math.pi)
    romg = omega - omega[0]
    freq_tv = mode_freq[None, :] + romg[:, None]  # (Nt, n)
    sig0_tv, _ = t60_to_sigma_tv(
        np.asarray(T60, np.float64), np.asarray(f0, np.float64),
        2.0 * np.asarray(f0, np.float64) * float(kappa)
    )
    ti = np.arange(Nt, dtype=np.float64) / sr
    damping = np.exp(-ti * sig0_tv)

    hz = freq_tv / (2 * np.pi) * sr
    aa = (hz < sr / 2).astype(np.float32) + 1e-4
    phase = np.add.accumulate(freq_tv, axis=0)
    tbank = np.cos(phase).astype(np.float32) * aa
    tbank *= damping.astype(np.float32)[:, None]

    sel = np.concatenate([np.asarray(x_keep, np.int64), [n_grid]])
    amps_ext = np.concatenate(
        [mode_amps, mode_amps.sum(axis=1, keepdims=True)], axis=1
    )  # (n, n_grid + 1): kept columns + full-grid sum
    out = tbank @ np.ascontiguousarray(amps_ext[:, sel].astype(np.float32))
    ua_keep, uas = out[:, :-1], out[:, -1]

    rms = float(np.sqrt(np.mean(uas**2))) or 1.0
    ua_f0, _ = ufreq.track_f0(uas / rms, sr)
    return ua_keep, uas, mode_freq, mode_amps[:, np.asarray(x_keep)], ua_f0
