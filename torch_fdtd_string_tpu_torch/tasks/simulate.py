"""Dataset-generation task: parameter draws, the width-bucketed string
kernel, NaN/silence skip, and the archival or the fused training artifacts.

PyTorch port of ``torch_fdtd_string_tpu/tasks/simulate.py`` (reference
``src/task/simulate.py``).  Per batch: numpy parameter draws
(``core/params.py``), the first two state rows (``ops/fdm.py``), one call of
the width-bucketed string kernel over all steps
(``ops/string_kernel.py::string_chunked_bucketed``), then per written item:

* the classic archival contract (``task.fuse_preprocess=false``):
  ``output{,-u,-z}.wav``, ``simulation.npz`` (with the full ``state_u`` /
  ``state_z`` fields and the ``v_r``/``F_H``/``u_H`` probe traces),
  ``{string,bow,hammer}_params.npz`` and ``simulation_config.yaml``;
* fused preprocessing (``task.fuse_preprocess=true``, the nsynth-like
  default): the state field stays on the device, where
  ``ops/postproc.py::postprocess_batch`` reduces it to the kept training
  columns; each item's DMSP layout (per-x wavs, ``vt.wav``,
  ``parameters.npz``) goes to ``<save_dir>-prep/`` with a
  ``_gen_meta.jsonl`` provenance line per run, and the run-dir artifacts
  are state-free.  A batch whose width spread reaches ``POSTPROC_G`` (and
  every float64 run) is post-processed on the host from each item's
  native-width state.

A float64 run (``task.precision=double``: the verification experiments
``linear-string`` and ``nonlinear-string`` by default) takes the scan
engine (``core/engine.py``) on the run's device (the card unless
``proc.cpu=true``) in chunks of ``task.chunk_length``, as the JAX package
runs every float64 run, and with
``task.write_during_process`` rewrites each string's
``{save_dir}/{it}/{sr}-{b}/output{-u,-z,}.wav`` after every chunk; the
string kernel's route ignores that option, as the JAX kernel route does.

With ``task.rescue_nan`` (the default; ``experiment=nsynth-like`` turns
it off) a single-precision run takes the NaN rescue ladder: the strings
the first pass poisons run again through the kernel's GMRES instance,
only those rows, in place, on the card (stage 1); those still NaN run
again in float64 through the scan engine on the host (stage 2,
``rescue_nan_elements``) and are spliced in, and the fused path builds
their items on the host from the rescued state.

Per run: ``skip_stats.json`` (per batch the first-pass NaNs, the strings
each stage saved, the NaN and silence skips) and the timing log
``gpu_time.txt`` (CUDA) or ``cpu_time.txt`` (CPU); a fused run's
``skip_stats.json`` also carries the writer phases' times and the
device-to-host bytes.

With ``task.load_config=<dir>`` the batch's draws take the ``.npy``
presets of ``tasks/preprocess_data.py`` (:func:`_load_presets`).

The device is chosen explicitly: the CPU for ``proc.cpu=true`` (where a
single-precision run takes the kernel's plain PyTorch version), CUDA
otherwise in either precision, and a host without a usable card raises.
``task.plot`` draws each written item's spectrogram, f0, phase and
parameter panels and ``task.plot_state`` its string-motion video
(``utils/plot.py``, as the JAX package draws them); without matplotlib
either raises an ``ImportError`` before any work.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import json
import os
import threading
import time

import numpy as np
import torch

from ..core import params as prm
from ..core.engine import (BowParams, Carry, HammerParams, SimConsts,
                           StringParams, simulate_chunk)
from ..ops import fdm
from ..ops.string_kernel import (bucket_groups, shard_groups, string_chunked_bucketed,
                                 string_chunked_rerun)
from ..parallel import mesh
from ..utils import audio
from ..utils import misc as ms
from ..utils import plot as uplot
from ..utils import wav as wavio


def select_device(cpu=False, precision="single"):
    """The CPU for ``proc.cpu=true``, else CUDA in either precision (an H100
    runs float64 natively): ``cuda:<LOCAL_RANK>`` in a multi-rank run
    (``parallel/mesh.py``), else ``cuda``; raises when CUDA is asked for
    and the host has no usable card."""
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            f"a {precision}-precision run needs a CUDA card and torch finds "
            "none; pass proc.cpu=true to run on the CPU")
    return mesh.local_device(cpu)


def kernel_gmres_rerun_enabled(task, args):
    """Whether a run takes rescue-ladder stage 1, the re-run of the first
    pass's NaN strings through the GMRES instance of the string kernel: a
    single-precision run on the card with ``task.rescue_nan`` on (the
    default; ``experiment=nsynth-like`` turns it off, and then NaN strings
    are skipped, as the reference skips them)."""
    return (not args.proc.cpu
            and task.get("precision", "single") != "double"
            and bool(task.get("rescue_nan", True)))


def kernel_inputs(state, consts: SimConsts, Nt, device, bow=None, hammer=None,
                  bow_mask=None, hammer_mask=None):
    """Positional tensors and keyword arguments of the batch's
    :func:`string_chunked` call: steps 2..Nt-1, run dtype, on ``device``.
    The ``bow`` / ``hammer`` dicts are built as the JAX package builds them
    (its ``_process_pallas``) when ``consts`` has that excitation."""
    dtype = torch.float64 if state.u0.dtype == np.float64 else torch.float32

    def to(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    sp = StringParams(
        kappa=to(state.kappa), alpha=to(state.alpha), p_a=to(state.p_a),
        f0=to(state.f0[:, 2:Nt]), pos=to(state.pos), T60=to(state.T60),
    )
    u1, u2 = fdm.initialize_state_rows(state.u0, state.v0, consts.k)
    B = state.u0.shape[0]
    zl = lambda: torch.zeros((B, consts.M_l), dtype=dtype, device=device)
    args = (sp.f0, sp.kappa, sp.alpha, sp.pos, sp.T60, to(u1), to(u2), zl(), zl())
    kwargs = dict(
        k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
        M_t=consts.M_t, M_l=consts.M_l,
        # sweep cap: the kernel's 24 reaches f32's tolerance; f64's is 2**29
        # times tighter, and after a bow's stick-slip switch has halved the
        # relaxation (~0.46 per sweep) it takes ~35 sweeps to reach it
        coupling_iters=24 if dtype == torch.float32 else 64,
        surface_integral=consts.surface_integral,
        collect_state=consts.collect_state,
        relative_error=consts.relative_error,
        manufactured=consts.manufactured, mms_centered=consts.mms_centered,
        # the MMS forcing's amplitude, in the run's dtype (the JAX
        # _process_pallas passes it the same way)
        p_a=sp.p_a if consts.manufactured else None,
        # poison-only first pass: untrusted coupling exits become NaN
        gmres_rescue=False,
    )
    if consts.has_bow or consts.has_hammer:
        # the initial hammer displacements: uH1 the newer row (step 1)
        uH = dict(uH1=to(hammer.u_H[:, 1]), uH2=to(hammer.u_H[:, 0]))
        mask = lambda m: torch.as_tensor(np.asarray(m, bool), device=device)
    if consts.has_bow:
        kwargs["bow"] = dict(
            x_b=to(bow.x_b[:, 2:Nt]), v_b=to(bow.v_b[:, 2:Nt]),
            F_b=to(bow.F_b[:, 2:Nt]), wid=to(bow.wid[:, 2:Nt]),
            phi_0=to(bow.phi_0), phi_1=to(bow.phi_1), mask=mask(bow_mask), **uH,
        )
    if consts.has_hammer:
        kwargs["hammer"] = dict(
            x_H=to(hammer.x_H), w_H=to(hammer.w_H), M_r=to(hammer.M_r),
            alpha=to(hammer.alpha), mask=mask(hammer_mask), **uH,
        )
    return args, kwargs


class RunStats:
    """One run's device-to-host byte count and writer-phase timings,
    shared by the simulation loop and the writer threads.

    ``link_bytes`` counts every array pulled from the simulation device to
    the host (on the CPU the pulls are free, and counted all the same),
    ``state_bytes`` the state fields a fused run leaves on the device;
    ``phases`` holds the writer phases' wall seconds and call counts:
    ``pull`` (waiting for a batch's post-processed arrays), ``assemble``
    (an item from the device post-processing), ``host_build`` (an item
    through ``build_processed`` from its native-width state) and ``write``
    (the item's wavs and ``parameters.npz``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.link_bytes = 0
        self.state_bytes = 0  # of the state fields left on the device
        self.phases = {}
        self.width_spread = []  # per batch of a fused run

    def count(self, nbytes):
        with self._lock:
            self.link_bytes += int(nbytes)

    def time(self, phase, dt):
        with self._lock:
            tot, n = self.phases.get(phase, (0.0, 0))
            self.phases[phase] = (tot + dt, n + 1)

    def snapshot(self):
        """What :meth:`merge` takes from each rank."""
        with self._lock:
            return (self.link_bytes, self.state_bytes, dict(self.phases),
                    list(self.width_spread))

    def merge(self, snapshots):
        """Every rank's :meth:`snapshot` (this rank's among them), summed:
        the bytes, and each writer phase's seconds and calls.  The width
        spreads are the whole batch's on every rank, so rank 0's stay."""
        if len(snapshots) < 2:
            return
        with self._lock:
            self.link_bytes = sum(s[0] for s in snapshots)
            self.state_bytes = sum(s[1] for s in snapshots)
            self.phases = {}
            for _, _, phases, _ in snapshots:
                for key, (t, n) in phases.items():
                    tot, cnt = self.phases.get(key, (0.0, 0))
                    self.phases[key] = (tot + t, cnt + n)
            self.width_spread = list(snapshots[0][3])

    def save_timing(self):
        """Per phase ``{total_s, n, ms_each}``, as the JAX package's
        ``save_timing`` reports them."""
        with self._lock:
            return {key: {"total_s": round(t, 3), "n": n,
                          "ms_each": round(t / n * 1e3, 1)}
                    for key, (t, n) in self.phases.items()}


class _HostCopy:
    """Device tensors copied to the host without stalling the device
    stream: on CUDA the copies go on a side stream into pinned buffers,
    started at construction, so they overlap the next batch's kernel;
    ``get()`` waits for them once and returns numpy arrays, counting their
    bytes in ``stats``.  CPU tensors are handed over as they are."""

    _streams = {}  # device index -> copy stream
    _streams_lock = threading.Lock()

    def __init__(self, tensors, stats):
        self._stats = stats
        self._lock = threading.Lock()
        self._val = None
        self._event = None
        self._host = {}
        for key, x in tensors.items():
            if not x.is_cuda:
                self._host[key] = x
                continue
            if self._event is None:
                with _HostCopy._streams_lock:
                    stream = _HostCopy._streams.get(x.device.index)
                    if stream is None:
                        stream = _HostCopy._streams[x.device.index] = (
                            torch.cuda.Stream(x.device))
                stream.wait_stream(torch.cuda.current_stream(x.device))
                self._event = torch.cuda.Event()
            with torch.cuda.stream(stream):
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                x.record_stream(stream)  # x stays allocated until copied
            self._host[key] = buf
        if self._event is not None:
            self._event.record(stream)

    def get(self):
        with self._lock:
            if self._val is None:
                if self._event is not None:
                    self._event.synchronize()
                self._val = {key: x.numpy() for key, x in self._host.items()}
                self._stats.count(sum(x.nbytes for x in self._val.values()))
                self._host = None
            return self._val


class _DeviceState:
    """The transverse state of a fused batch, left on the simulation
    device: ``post`` holds the batch's post-processed arrays
    (:class:`_HostCopy` of :func:`..ops.postproc.postprocess_batch`), or is
    None when the batch takes the host path, where
    :meth:`fetch_element` pulls one string's native-width slice."""

    def __init__(self, su, u1_init, u2_init, post, stats, keep=False):
        self.post = post
        # free the field once consumed, unless a figure reads it (``keep``)
        self._su = su if post is None or keep else None
        self._head = (u2_init, u1_init)
        self._stats = stats
        self.rescued = {}  # b -> (Nt, M) host state of an f64-rescued string

    def fetch_element(self, b, w):
        """String ``b``'s rows at its live width ``w``, ``(Nt, w)`` float32
        (the two initial rows first)."""
        if b in self.rescued:
            return np.asarray(self.rescued[b][:, :w], np.float32)
        body = self._su[:, b, :w].to(device="cpu", dtype=torch.float32).numpy()
        self._stats.count(body.nbytes)
        head = np.stack([self._head[0][b, :w], self._head[1][b, :w]])
        return np.concatenate([head.astype(np.float32), body], axis=0)


class _Readout:
    """Row access to one ``(B, T)`` readout of a batch's :class:`_HostCopy`."""

    def __init__(self, copy, key):
        self._copy = copy
        self._key = key

    def __getitem__(self, i):
        return self._copy.get()[self._key][i]


_OSTACK = {}  # (device, M, keep, grid) -> spline operator stack on device
_OSTACK_LOCK = threading.Lock()


def _ostack_device(M, keep, n_grid, device):
    """The spline operator stack on ``device``, uploaded once per process."""
    from ..ops import postproc as pp

    key = (str(device), int(M), tuple(int(i) for i in keep), int(n_grid))
    with _OSTACK_LOCK:
        dev = _OSTACK.get(key)
    if dev is None:
        dev = torch.as_tensor(pp.spline_operator_stack(M, np.asarray(keep), n_grid=n_grid),
                              device=device)
        with _OSTACK_LOCK:
            dev = _OSTACK.setdefault(key, dev)
    return dev


# widths per string that the device post-processing sweeps: the f0 sampler
# bounds the drift to ~8%, a spread of ~20 widths; a batch that spreads
# wider is post-processed on the host
POSTPROC_G = 32


def process(state, bow, hammer, bow_mask, hammer_mask, consts: SimConsts, Nt,
            device, sr=48000, postproc_keep=None, stats=None, kernel_gmres=None,
            chunk_size=None, save_path=None, skip_nan=True, rows=None, keep_state=False):
    """Run one batch through the width-bucketed string kernel (steps
    2..Nt-1), or a float64 batch through the scan engine
    (:func:`process_engine`, in chunks of ``chunk_size`` samples, writing
    the readout wavs under ``save_path`` after each chunk when it is set,
    and raising on a NaN string after a chunk unless ``skip_nan``; the
    kernel's route leaves NaN strings to the caller, as the JAX package's
    does).

    Returns ``(uout, zout, state_u, state_z, v_r, F_H, u_H, sig0, sig1)``.
    Without ``postproc_keep`` every array is numpy and the state fields are
    ``(B, Nt, M)`` with the two initial rows first, or ``None`` without
    ``consts.collect_state``.  With ``postproc_keep = (keep, n_grid)``
    (fused preprocessing) the state stays on ``device``: ``uout``/``zout``
    are the device tensors, ``state_u`` is a :class:`_DeviceState` whose
    ``post`` carries the batch's :func:`..ops.postproc.postprocess_batch`
    outputs when its width spread is below ``G`` (float32 runs; the field
    itself is then freed unless ``keep_state``, for the state video), and
    ``state_z`` is None.  Pulls are counted in ``stats``.

    ``kernel_gmres``, a dict, turns on rescue-ladder stage 1: the strings
    the first pass leaves NaN run again through the GMRES instance of the
    kernel, written in place into the batch's outputs before any of them is
    read (``string_chunked_rerun``: only those rows, at their widths in the
    batch's grouping, so the result equals a whole-batch re-run); the first
    pass's ``(B,)`` NaN flags go to ``kernel_gmres["nan_first_pass"]``.

    ``rows`` (a slice; a rank's share of a sharded batch,
    ``parallel/mesh.py::shard_rows``) runs those strings of the whole
    batch's draws alone, and every result is theirs.  What the whole batch
    decides is decided from all of it, as the single-card run decides it:
    the width groups of the kernel's launch (:func:`shard_groups`), so
    each string runs at its single-card width and equals its single-card
    result bit for bit, the fused path's host-or-device post-processing,
    and the kernel instance (``consts``).  A float64 batch's engine exits
    its coupling sweeps when the rank's strings have converged, so there
    the rows equal the single-card run's to the sweeps' tolerance.
    """
    stats = stats or RunStats()
    groups = spread = None
    if rows is not None:
        B_all = state.u0.shape[0]
        if state.u0.dtype != np.float64:
            groups = shard_groups(bucket_groups(
                state.f0[:, 2:Nt], state.kappa, state.alpha, k=consts.k,
                theta_t=consts.theta_t, lambda_c=consts.lambda_c, M_t=consts.M_t,
                M_l=consts.M_l), rows)
            if postproc_keep is not None:
                spread = _widths_spread(state, consts)
        state, bow, hammer, bow_mask, hammer_mask = shard_draws(
            rows, B_all, state, bow, hammer, bow_mask, hammer_mask)
    if state.u0.dtype == np.float64:
        return _process_double(state, bow, hammer, bow_mask, hammer_mask, consts,
                               Nt, chunk_size or Nt, device, sr, postproc_keep,
                               stats, save_path, skip_nan,
                               0 if rows is None else rows.start)
    args, kwargs = kernel_inputs(state, consts, Nt, device, bow, hammer,
                                 bow_mask, hammer_mask)
    # host copies of the draws for the bucketing bounds
    host_bounds = (state.f0[:, 2:Nt], state.kappa, state.alpha)
    uout_d, zout_d, aux = string_chunked_bucketed(*args, host_bounds=host_bounds,
                                                  groups=groups, **kwargs)
    if kernel_gmres is not None:
        nan_first = torch.isnan(uout_d.sum(-1)).cpu().numpy()
        stats.count(nan_first.nbytes)
        kernel_gmres["nan_first_pass"] = nan_first
        nan_rows = np.nonzero(nan_first)[0]
        if len(nan_rows):
            print(f"[simulate] kernel-GMRES re-run for diverged element(s) "
                  f"{nan_rows.tolist()}", flush=True)
            string_chunked_rerun(*args, rows=nan_rows, out=(uout_d, zout_d, aux),
                                 host_bounds=host_bounds, groups=groups,
                                 **dict(kwargs, gmres_rescue=True))
    np_dt = state.u0.dtype
    B, T = uout_d.shape

    def pull(x):
        out = x.cpu().numpy()
        stats.count(out.nbytes)
        return out

    if consts.has_bow or consts.has_hammer:
        v_r = pull(aux["v_r"])
        F_H = pull(aux["F_H"])
        u_H = pull(aux["u_H"]) / consts.k
    else:
        # excitation-free run: zero probe traces and the free ballistic
        # hammer ramp in closed form (engine fast-path semantics)
        vstep = hammer.u_H[:, 1] - hammer.u_H[:, 0]
        n = np.arange(1, T + 1)[None, :]
        u_H = ((hammer.u_H[:, 1][:, None] + n * vstep[:, None]) / consts.k).astype(np_dt)
        v_r = np.zeros((B, T), np_dt)
        F_H = np.zeros((B, T), np_dt)
    gamma = 2.0 * state.f0[:, -1]
    # the last step's loss terms, in the run's dtype as the engine gives them
    sig0, sig1 = (np.asarray(x, np_dt) for x in
                  audio.T60_to_sigma(state.T60, gamma, state.kappa * gamma))
    u1, u2 = args[5], args[6]
    if postproc_keep is not None:
        stats.state_bytes += sum(aux[key].numel() * aux[key].element_size()
                                 for key in ("state_u", "state_z"))
        post = None
        if u1.dtype == torch.float32:
            from ..ops import postproc as pp

            G = POSTPROC_G
            if spread is None:
                spread = _widths_spread(state, consts)
            stats.width_spread.append(spread)
            if spread < G:
                keep_idx, keep_grid = postproc_keep
                out_dev = pp.postprocess_batch(
                    aux["state_u"], u1, u2, args[0].new_tensor(state.f0[:, :2]),
                    args[0], args[1],
                    _ostack_device(consts.M_t, keep_idx, keep_grid, device),
                    k=consts.k, theta_t=consts.theta_t,
                    lambda_c=consts.lambda_c, sr=sr, G=G)
                post = _HostCopy(out_dev, stats)
            else:
                print(f"[simulate] width spread {spread} >= {G}; this batch "
                      "takes the host path", flush=True)
        u1_h, u2_h = fdm.initialize_state_rows(state.u0, state.v0, consts.k)
        handle = _DeviceState(aux["state_u"], u1_h, u2_h, post, stats, keep=keep_state)
        return uout_d, zout_d, handle, None, v_r, F_H, u_H, sig0, sig1
    uout, zout = pull(uout_d), pull(zout_d)
    if not consts.collect_state:
        return uout, zout, None, None, v_r, F_H, u_H, sig0, sig1
    z0 = torch.zeros((B, 2, consts.M_l), dtype=u1.dtype, device=u1.device)
    state_u = torch.cat(
        [u2[:, None], u1[:, None], aux["state_u"].transpose(0, 1)], dim=1)
    state_z = torch.cat([z0, aux["state_z"].transpose(0, 1)], dim=1)
    return (uout, zout, pull(state_u), pull(state_z),
            v_r, F_H, u_H, sig0, sig1)


def _widths_spread(state, consts):
    """The batch's width spread (``ops/postproc.py::host_widths_spread``)."""
    from ..ops import postproc as pp

    return pp.host_widths_spread(np.asarray(state.f0, np.float32), np.asarray(state.kappa),
                                 consts.k, consts.theta_t, consts.lambda_c)


def shard_draws(rows, B, *draws):
    """The rows ``rows`` of each of a batch's draws: the params dataclasses'
    batch-major arrays, and masks."""
    return tuple(d[rows] if isinstance(d, np.ndarray) else _slice_batch(d, rows, B)
                 for d in draws)


def _process_double(state, bow, hammer, bow_mask, hammer_mask, consts, Nt,
                    chunk_size, device, sr, postproc_keep, stats, save_path, skip_nan,
                    first_row=0):
    """:func:`process` of a float64 batch: the scan engine, as the JAX
    package runs every float64 run.  A fused run gets its readouts as
    tensors and its state as a :class:`_DeviceState` with no device
    post-processing: every item takes the host build."""
    out = process_engine(state, bow, hammer, bow_mask, hammer_mask, consts, Nt,
                         chunk_size, device, collect_state=consts.collect_state,
                         save_path=save_path, sr=sr, skip_nan=skip_nan,
                         first_row=first_row)
    stats.count(sum(x.nbytes for x in out if isinstance(x, np.ndarray)))
    if postproc_keep is None:
        return out
    uout, zout, state_u, state_z, v_r, F_H, u_H, sig0, sig1 = out
    stats.state_bytes += state_u.nbytes + state_z.nbytes
    u1_h, u2_h = fdm.initialize_state_rows(state.u0, state.v0, consts.k)
    body = torch.from_numpy(state_u[:, 2:]).transpose(0, 1)  # (T, B, M)
    handle = _DeviceState(body, u1_h, u2_h, None, stats)
    return (torch.from_numpy(uout), torch.from_numpy(zout), handle, None,
            v_r, F_H, u_H, sig0, sig1)


def process_engine(state, bow, hammer, bow_mask, hammer_mask,
                   consts: SimConsts, Nt, chunk_size, device, collect_state=True,
                   save_path=None, sr=48000, skip_nan=True, first_row=0):
    """One batch through the scan engine (``core/engine.py``), the JAX
    ``process`` engine branch: steps 2..Nt-1 in chunks of ``chunk_size - 2``
    steps (the reference's 2-sample overlap, simulate.py:57-107, which the
    carry implements), in the draws' dtype, on ``device``.  Returns numpy
    ``(uout, zout, state_u, state_z, v_r, F_H, u_H, sig0, sig1)``, the state
    fields ``(B, Nt, M)`` with the two initial rows first (``None`` without
    ``collect_state``).

    With ``save_path``, every string not NaN so far has its readouts up to
    the chunk's end written to ``{save_path}-{first_row + b}/output{-u,-z,}.wav``
    (PCM_16, not normalized) after each chunk, as the JAX package writes
    them with ``task.write_during_process``.  Without ``skip_nan`` a string
    that is NaN at a chunk's end raises ``FloatingPointError`` (the JAX
    package asserts the same, simulate.py:774-776)."""
    dtype = torch.float64 if state.u0.dtype == np.float64 else torch.float32
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    to = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
    B = state.u0.shape[0]
    M_l = consts.M_l
    u1_init, u2_init = fdm.initialize_state_rows(state.u0, state.v0, consts.k)
    carry = Carry(u1=to(u1_init), u2=to(u2_init),
                  z1=torch.zeros((B, M_l), dtype=dtype, device=device),
                  z2=torch.zeros((B, M_l), dtype=dtype, device=device),
                  uH1=to(hammer.u_H[:, 1]), uH2=to(hammer.u_H[:, 0]))
    sp = StringParams(kappa=to(state.kappa), alpha=to(state.alpha), p_a=to(state.p_a),
                      f0=to(state.f0), pos=to(state.pos), T60=to(state.T60))
    bp = BowParams(x_b=to(bow.x_b), v_b=to(bow.v_b), F_b=to(bow.F_b),
                   phi_0=to(bow.phi_0), phi_1=to(bow.phi_1), wid=to(bow.wid))
    hp = HammerParams(x_H=to(hammer.x_H), w_H=to(hammer.w_H), M_r=to(hammer.M_r),
                      alpha=to(hammer.alpha))
    bmask = torch.as_tensor(np.asarray(bow_mask, bool), device=device)
    hmask = torch.as_tensor(np.asarray(hammer_mask, bool), device=device)
    consts = consts._replace(collect_state=bool(collect_state))
    outs = []
    for cs in range(2, Nt, max(chunk_size - 2, 1)):
        ce = min(cs + chunk_size - 2, Nt)
        carry, out = simulate_chunk(carry, range(cs, ce), sp, bp, hp, bmask, hmask,
                                    consts)
        outs.append({key: v.cpu().numpy() for key, v in out.items()})
        if not skip_nan:
            bad = np.nonzero(np.isnan(outs[-1]["uout"]).any(axis=0))[0]
            if len(bad):
                raise FloatingPointError(
                    f"string(s) {bad.tolist()} NaN by step {ce} (task.skip_nan=false)")
        if save_path is not None:
            _write_readouts(save_path, [o["uout"] for o in outs],
                            [o["zout"] for o in outs], sr, first_row)
    cat = lambda key: np.concatenate([o[key] for o in outs], axis=0).T  # (B, T)
    sig0, sig1 = outs[-1]["sig0"][-1], outs[-1]["sig1"][-1]
    state_u = state_z = None
    if collect_state:
        state_u = np.concatenate(
            [np.asarray(u2_init, np_dt)[:, None], np.asarray(u1_init, np_dt)[:, None]]
            + [o["u"].transpose(1, 0, 2) for o in outs], axis=1)
        state_z = np.concatenate(
            [np.zeros((B, 2, M_l), np_dt)] + [o["z"].transpose(1, 0, 2) for o in outs],
            axis=1)
    # the reference divides u_H by k on return (simulator.cpp:57)
    return (cat("uout"), cat("zout"), state_u, state_z, cat("v_r"), cat("F_H"),
            cat("u_H") / consts.k, sig0, sig1)


def _write_readouts(save_path, uout_chunks, zout_chunks, sr, first_row=0):
    """The readouts so far, ``(T, B)`` chunks, as each non-NaN string's
    ``{save_path}-{first_row + b}/output{-u,-z,}.wav``."""
    uout = np.concatenate(uout_chunks, axis=0).T  # (B, T)
    zout = np.concatenate(zout_chunks, axis=0).T
    nan_b = np.isnan(uout.sum(-1))
    for b in range(uout.shape[0]):
        if nan_b[b]:
            continue
        d = f"{save_path}-{first_row + b}"
        os.makedirs(d, exist_ok=True)
        wavio.write(f"{d}/output-u.wav", uout[b], sr, "PCM_16")
        wavio.write(f"{d}/output-z.wav", zout[b], sr, "PCM_16")
        wavio.write(f"{d}/output.wav", uout[b] + zout[b], sr, "PCM_16")


def _slice_batch(obj, idx, B, cast_f64=False):
    """The rows ``idx`` of a params dataclass's batch-major arrays."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == B:
            v = v[idx]
            if cast_f64 and np.issubdtype(v.dtype, np.floating):
                v = v.astype(np.float64)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def rescue_inputs(string, bow, hammer, bow_mask, hammer_mask, idx,
                  consts: SimConsts):
    """:func:`process_engine`'s batch arguments for the strings ``idx`` of
    a batch: their draws in float64 and the constants with the GMRES
    coupled solve, ``(string, bow, hammer, bow_mask, hammer_mask,
    consts)``."""
    B = len(bow_mask)
    bm2, hm2 = np.asarray(bow_mask)[idx], np.asarray(hammer_mask)[idx]
    consts2 = consts._replace(
        has_bow=bool(np.any(bm2)), has_hammer=bool(np.any(hm2)),
        # strongly coupled draws mix large-negative and near-one GS
        # eigenvalues, where no damping factor converges: the Krylov solve
        coupling_solver="gmres", coupling_max_iter=64,
    )
    return (_slice_batch(string, idx, B, cast_f64=True),
            _slice_batch(bow, idx, B, cast_f64=True),
            _slice_batch(hammer, idx, B, cast_f64=True), bm2, hm2, consts2)


def rescue_nan_elements(string, bow, hammer, bow_mask, hammer_mask, idx,
                        consts: SimConsts, Nt, chunk_size, sr):
    """Rescue-ladder stage 2: the strings ``idx`` simulated again in float64
    by the scan engine with the GMRES coupled solve, in one batched call
    (each string has its own Krylov space, so a hopeless NaN string cannot
    touch its neighbours).  Returns :func:`process_engine`'s numpy arrays
    for those strings.

    This runs on the host CPU, as the JAX package runs it: it is a stage of
    the algorithm (strongly coupled draws need the exact joint solve in
    float64, where the reference's dense solve stays stable), not a fallback
    from the card.  The first pass and the GMRES re-run run only on the
    card, and a single-precision run without one still raises.
    """
    return process_engine(
        *rescue_inputs(string, bow, hammer, bow_mask, hammer_mask, idx, consts),
        Nt, chunk_size, torch.device("cpu"), collect_state=consts.collect_state)


def draw_params(model_name, sr, theta_t, length, batch_size, f0_inf,
                alpha_inf, lambda_c, *, string_kwargs=None, hammer_kwargs=None,
                bow_kwargs=None, precision="single", randomize_each="batch",
                manufactured=False, rng=None):
    """Sample one batch's instruments (reference simulate.py:121-163).
    Returns ``(string, bow, hammer, bow_mask, hammer_mask, pluck_mask)``."""
    rng = rng or np.random.default_rng()
    k = 1.0 / sr
    pluck_batch = (
        True if model_name.endswith("pluck") else None if model_name == "random" else False
    )
    bow_mask, hammer_mask = prm.get_masks(rng, model_name, batch_size)
    pluck_mask = ~(bow_mask | hammer_mask)
    string = prm.sample_string(
        rng, k=k, theta_t=theta_t, lambda_c=lambda_c, sr=sr, length=length,
        f0_inf=f0_inf, alpha_inf=alpha_inf, batch_size=batch_size,
        precision=precision, pluck_batch=pluck_batch, pluck_mask=pluck_mask,
        hammer_mask=hammer_mask, randomize_each=randomize_each,
        manufactured=manufactured, **(string_kwargs or {}),
    )
    bow = prm.sample_bow(
        rng, sr=sr, length=length, batch_size=batch_size, precision=precision,
        randomize_each=randomize_each, **(bow_kwargs or {}),
    )
    hammer = prm.sample_hammer(
        rng, sr=sr, length=length, batch_size=batch_size, precision=precision,
        k=k, randomize_each=randomize_each, **(hammer_kwargs or {}),
    )
    return string, bow, hammer, bow_mask, hammer_mask, pluck_mask


def _load_presets(load_config, total_size, string, bow, hammer, k):
    """Apply the ``<model>-<param>.npy`` overrides of the directory
    ``load_config`` in place (JAX ``tasks/simulate.py::_load_presets``,
    reference simulate.py:164-182).

    Each file is edge-padded or cut to ``total_size`` samples.
    ``string-f0`` is the target: it sets ``target_f0`` and, divided by each
    string's Fletcher factor w0, the simulation's ``f0``; another string
    parameter is set as given.  Bow parameters are broadcast over the
    batch.  ``hammer-v_H`` sets ``v_H`` and the hammer's displacement rows
    ``u_H = M_HD_INIT + k v_H`` on the first two samples (``k v_H`` after
    them); the string step reads only those two rows of the hammer, so
    the hammer leaves from rest unless the profile moves in its first two
    samples.
    """
    for npy_path in glob.glob(f"{load_config}/*.npy"):
        val = np.load(npy_path)
        if val.shape[-1] < total_size:
            val = np.pad(val, (0, total_size - val.shape[-1]), mode="edge")
        else:
            val = val[:total_size]
        target_model, target_param = os.path.basename(npy_path).split(".")[0].split("-")
        tm = target_model.lower()
        if tm == "string":
            if target_param == "f0":
                w0 = np.asarray(fdm.stiff_string_modes(0.0, string.kappa.reshape(-1, 1), 1)[1][0])
                string.f0 = (val[None, :] / w0).astype(string.f0.dtype)
                string.target_f0 = np.broadcast_to(
                    val, string.target_f0.shape).astype(string.f0.dtype)
            else:
                setattr(string, target_param, np.asarray(val, string.f0.dtype))
        elif tm == "bow":
            cur = getattr(bow, target_param)
            setattr(bow, target_param, np.broadcast_to(val, cur.shape).astype(cur.dtype))
        elif tm == "hammer":
            if target_param == "v_H":
                profile = val[None, :].astype(hammer.v_H.dtype)
                hammer.v_H = np.broadcast_to(profile, hammer.v_H.shape).copy()
                u_H = np.zeros_like(hammer.v_H)
                u_H[:, :2] += prm.M_HD_INIT
                hammer.u_H = u_H + k * hammer.v_H
            else:
                cur = getattr(hammer, target_param)
                setattr(hammer, target_param, np.broadcast_to(val, cur.shape).astype(cur.dtype))
        else:
            raise ValueError(f"{npy_path}: unknown model {target_model!r} "
                             "(string, bow or hammer)")


def check_allocation(string, k, theta_t, lambda_c, f0_inf):
    """Raise when a preset's f0 needs a wider grid than the batch's
    allocation, which the sampler sizes from ``task.f0_inf`` before the
    presets replace ``f0``.

    The JAX package runs such a preset unchecked: its kernel keeps the
    extra grid points on its 128-lane padding (up to 384 lanes at
    nsynth-like) and cuts the saved ``state_u`` at the allocation, while
    its scan engine has no lanes past the allocation.  The port's launch
    has no such padding to borrow: the string would run on a cut grid.
    """
    _, _, Nx_t, _, Nx_l, _ = fdm.get_derived_vars_host(
        string.f0, string.kappa[:, None], k, theta_t, lambda_c,
        string.alpha[:, None], dtype=string.f0.dtype)
    if Nx_t.max() > string.Nx_t or Nx_l.max() > string.Nx_l:
        raise ValueError(
            f"the preset's f0 (down to {float(string.target_f0.min()):.2f} Hz) needs "
            f"{int(Nx_t.max())} transverse / {int(Nx_l.max())} longitudinal intervals, "
            f"more than the {string.Nx_t} / {string.Nx_l} allocated from "
            f"task.f0_inf={f0_inf}; lower task.f0_inf below the preset's lowest f0")


def sim_consts(string, bow_mask, hammer_mask, sr, theta_t, lambda_c,
               relative_order=4, surface_integral=False, manufactured=False,
               collect_state=True):
    return SimConsts(
        k=1.0 / sr, theta_t=float(theta_t), lambda_c=float(lambda_c),
        relative_error=float(relative_order),
        M_t=string.Nx_t + 1, M_l=string.Nx_l + 1,
        surface_integral=bool(surface_integral),
        manufactured=bool(manufactured), collect_state=collect_state,
        has_bow=bool(np.any(bow_mask)), has_hammer=bool(np.any(hammer_mask)),
    )


def simulate(model_name, sr, theta_t, length, batch_size, f0_inf, alpha_inf,
             lambda_c, cpu=False, load_config=None, string_kwargs=None,
             hammer_kwargs=None, bow_kwargs=None, precision="single",
             relative_order=4, surface_integral=False, randomize_each="batch",
             manufactured=False, rng=None, collect_state=True,
             postproc_keep=None, stats=None, kernel_gmres=None,
             chunk_length=-1, save_path=None, skip_nan=True, rows=None, keep_state=False):
    """Draw one batch and simulate it (reference simulate.py:121-217).
    ``chunk_length`` (seconds, -1 for the whole run), ``save_path`` and
    ``skip_nan`` are the float64 engine's chunking, its
    ``write_during_process`` target and its NaN check (:func:`process`).

    Returns ``(results, (string, bow, hammer, [k, theta_t, lambda_c],
    consts), (bow_mask, hammer_mask, pluck_mask), device)``; ``results`` as
    :func:`process` returns them.  ``rows`` (a slice: a rank's share of
    the batch in a multi-rank run, ``parallel/mesh.py::shard_rows``)
    draws the whole batch from ``rng`` and simulates those rows alone; the
    draws and results returned are theirs.
    """
    string, bow, hammer, bow_mask, hammer_mask, pluck_mask = draw_params(
        model_name, sr, theta_t, length, batch_size, f0_inf, alpha_inf,
        lambda_c, string_kwargs=string_kwargs, hammer_kwargs=hammer_kwargs,
        bow_kwargs=bow_kwargs, precision=precision,
        randomize_each=randomize_each, manufactured=manufactured, rng=rng,
    )
    if load_config is not None:
        total_size = int(length * sr)
        _load_presets(load_config, total_size, string, bow, hammer, 1.0 / sr)
        check_allocation(string, 1.0 / sr, theta_t, lambda_c, f0_inf)
    consts = sim_consts(
        string, bow_mask, hammer_mask, sr, theta_t, lambda_c,
        relative_order=relative_order, surface_integral=surface_integral,
        manufactured=manufactured, collect_state=collect_state,
    )
    device = select_device(cpu, precision)
    total_size = int(length * sr)
    chunk_size = max(total_size if chunk_length < 0 else int(chunk_length * sr), 3)
    results = process(string, bow, hammer, bow_mask, hammer_mask, consts,
                      total_size, device, sr=sr,
                      postproc_keep=postproc_keep, stats=stats,
                      kernel_gmres=kernel_gmres, chunk_size=chunk_size,
                      save_path=save_path, skip_nan=skip_nan, rows=rows,
                      keep_state=keep_state)
    if rows is not None:
        string, bow, hammer, bow_mask, hammer_mask, pluck_mask = shard_draws(
            rows, batch_size, string, bow, hammer, bow_mask, hammer_mask, pluck_mask)
    k = 1.0 / sr
    return (results, (string, bow, hammer, [k, theta_t, lambda_c], consts),
            (bow_mask, hammer_mask, pluck_mask), device)


def task_kwargs(task):
    """``theta_t`` and the sampler keyword sets of a composed ``task``
    config (reference simulate.py:219-262)."""
    sr = task.sr

    def _cond(cond_list, key):
        vals = [d[key] for d in cond_list if key in d and d[key] is not None]
        return vals[0] if vals else None

    if task.sampling_kappa == "fix":
        kappa_max = _cond(task.string_condition, "kappa_fixed")
    else:
        kappa_max = _cond(task.string_condition, "kappa_max")
        if kappa_max is None:
            raise ValueError("Specify 'kappa_max' in task.string_condition")
    if task.sampling_f0 == "fix":
        f0_min = _cond(task.string_condition, "f0_fixed")
        if np.ndim(f0_min) > 0:
            f0_min = min(f0_min)
    else:
        f0_min = _cond(task.string_condition, "f0_min")
    theta_t = (
        fdm.get_theta(kappa_max, f0_min, sr) if task.theta_t is None else task.theta_t
    )

    string_kwargs = dict(
        sampling_f0=task.sampling_f0 or "random",
        sampling_kappa=task.sampling_kappa or "random",
        sampling_alpha=task.sampling_alpha or "random",
        sampling_pickup=task.sampling_pickup or "random",
        sampling_T60=task.sampling_T60 or "random",
        precorrect=True if task.precorrect is None else task.precorrect,
    )

    def _collect(conds, into):
        for d in conds:
            ((key, val),) = d.items()
            if val is not None:
                into[key] = val
        return into

    _collect(task.string_condition, string_kwargs)
    _collect(task.pluck_condition, string_kwargs)
    return dict(
        theta_t=theta_t,
        string_kwargs=string_kwargs,
        hammer_kwargs=_collect(task.hammer_condition, {}),
        bow_kwargs=_collect(task.bow_condition, {}),
    )


def _assemble_post_item(pz, b, _sim, _str, _bow, _ham, string, Nx_t,
                        fuse_keep, fuse_Nx, sr, save_modal):
    """One processed training item from the device-postprocessed arrays of
    its batch, with the key schema of :func:`..tasks.process_training_data.
    build_processed` (JAX ``tasks/simulate.py::_assemble_post_item``).

    ``gain`` comes from the live maximum at native width, where
    ``build_processed`` takes it over the upsampled grid (the spline's
    overshoot, ~1%); the gain scales estimate and target alike.
    """
    from ..ops import postproc as pp
    from ..utils import data as udata

    ut = np.asarray(pz["ut_keep"][b], np.float32)  # (Nt, K)
    Nt = ut.shape[0]
    vt = np.asarray(pz["vt"][b], np.float32)  # summed-velocity wav (k=1)
    gain = 1.0 / (float(pz["umax"][b]) + float(np.finfo(np.float32).eps))
    ti = np.arange(Nt, dtype=np.float64)[:, None] / sr
    xi = np.linspace(0, 1, fuse_Nx)

    w0 = int(np.asarray(Nx_t[b]).reshape(-1)[0]) + 1
    u0n = np.asarray(string.u0[b][:w0], np.float32)
    u0_grid = u0n @ udata.spline_matrix(w0, fuse_Nx).T

    ua_keep, _, mode_freq, ma_keep, ua_f0 = pp.modal_target_host(
        u0_grid, string.f0[b], string.kappa[b], string.T60[b], Nt, sr,
        fuse_keep, strict=False, synth=save_modal,
    )
    _sim = dict(_sim)
    _sim.update(
        ut_f0=np.asarray(pz["ut_f0"][b], np.float64),
        mode_freq=mode_freq,
        mode_amps=ma_keep,
        x=xi[np.asarray(fuse_keep)][None, :],
        t=ti,
        ut=ut,
        vt=vt,
        gain=float(gain),
    )
    if save_modal:
        _sim.update(ua=ua_keep, ua_f0=ua_f0)
    _str = dict(_str)
    _str.pop("v0", None)
    # u0 is the model's initial-profile input on the FULL training grid
    # (reference process_training_data.py:193), never the kept subset
    _str.update(u0=u0_grid[None, :])
    _bow = dict(_bow)
    _bow["ph0_B"] = _bow.pop("phi_0")
    _bow["ph1_B"] = _bow.pop("phi_1")
    _ham = dict(_ham)
    _ham["M_H"] = _ham.pop("M_r")
    _ham["a_H"] = _ham.pop("alpha")
    return {**_sim, **_str, **_bow, **_ham}


# the (Nt,) series that no training or evaluation loader reads, dropped from
# a prepared item by task.save_compact_params (the JAX data/dataset.py KEYS)
COMPACT_DROP = ("Nx_t", "Nx_l", "target_f0", "x_B", "v_B", "F_B", "wid_B",
                "v_H", "u_H")


def _dump_draw(path, b, why, string, bow, hammer, bow_mask, hammer_mask, consts):
    """String ``b``'s whole draw, to re-run it exactly (the JAX
    ``_dump_draw``, simulate.py:1565-1597, with ``task.dump_draws`` or,
    for the strings a batch skips, ``task.dump_skipped``): the same keys
    and values."""
    np.savez(
        path, why=why,
        kappa=string.kappa[b], alpha=string.alpha[b], u0=string.u0[b], v0=string.v0[b],
        p_a=string.p_a[b], f0=string.f0[b], pos=string.pos[b], T60=string.T60[b],
        x_b=bow.x_b[b], v_b=bow.v_b[b], F_b=bow.F_b[b], phi_0=bow.phi_0[b],
        phi_1=bow.phi_1[b], wid=bow.wid[b],
        x_H=hammer.x_H[b], v_H=hammer.v_H[b], u_H=hammer.u_H[b], w_H=hammer.w_H[b],
        M_r=hammer.M_r[b], alpha_H=hammer.alpha[b],
        bow_mask=np.asarray(bow_mask)[b], hammer_mask=np.asarray(hammer_mask)[b],
        k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
        relative_error=consts.relative_error, M_t=consts.M_t, M_l=consts.M_l,
        surface_integral=consts.surface_integral,
    )


def _merge_batch_stats(parts):
    """One batch's ``skip_stats.json`` entry from every rank's, in rank
    order: the counts summed, the rows and skips listed in rank order (with
    their indices in the whole batch), the f64 stage's wall the slowest
    rank's.  One rank's entry is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    out = dict(parts[0])
    for key in ("n", "nan_first_pass", "rescued_kernel_gmres", "rescued_f64",
                "nan_final", "silent", "written"):
        out[key] = sum(p[key] for p in parts)
    for key in ("rescue_f64_rows", "skipped"):
        items = [x for p in parts for x in p.get(key, [])]
        if items:
            out[key] = items
    secs = [p["rescue_f64_s"] for p in parts if "rescue_f64_s" in p]
    if secs:
        out["rescue_f64_s"] = max(secs)
    return out


def _build_once(task):
    """What every rank's run would build on first use into the checkout's
    file caches, built by rank 0 while the others wait, then loaded by
    them: the string kernel's library (single precision) and the modal
    solution's root table (fused preprocessing)."""
    with mesh.rank_zero_first():
        if task.get("precision", "single") != "double":
            from ..ops import build

            build.load_kernel_library("string_step")
        if task.get("fuse_preprocess", False):
            from ..core import analytic

            analytic.root_tables()


def run(args, save_dir, model_name, n_samples):
    """Dataset-generation loop (reference simulate.py:219-456).

    Classic archival contract, or with ``task.fuse_preprocess`` (the
    nsynth-like default) the DMSP training layout written straight from the
    run into ``<save_dir>-prep/`` (``task.fuse_save_dir``): per-x wavs and
    ``parameters.npz`` per item, from the on-device post-processing of the
    state field, which never leaves the device; a state-free
    ``simulation.npz`` per item with ``task.save``.  Returns the per-batch
    simulate wall times.

    In a multi-rank run (``parallel/mesh.py``; ``task.batch_size`` must
    divide by the world size) each rank simulates and writes its rows of
    every batch, under the indices the single-card run gives them; rank 0
    alone writes the job's files (``_gen_meta.jsonl``, the timing log with
    each batch's slowest rank, ``skip_stats.json`` summed over the ranks).
    """
    task = args.task
    sr = task.sr
    if task.plot or task.plot_state:
        uplot.require("task.plot" if task.plot else "task.plot_state")
    # every rank's share of a batch, refused before anything runs when the
    # batch does not divide
    share = mesh.shard_rows(task.batch_size)
    rank_rows = share if mesh.world_size() > 1 else None
    lead = mesh.rank() == 0
    if rank_rows is not None and not args.proc.cpu:
        _build_once(task)
    kw = task_kwargs(task)
    theta_t = kw.pop("theta_t")

    rng = np.random.default_rng(args.proc.seed)
    time_log = []
    skip_stats = []
    stats = RunStats()
    os.makedirs(save_dir, exist_ok=True)
    bitrate = "PCM_24" if task.precision == "double" else "PCM_16"

    fuse = bool(task.get("fuse_preprocess", False))
    fuse_stride = int(task.get("save_x_stride", 1) or 1)
    fuse_Nx = int(task.get("process_Nx", 256) or 256)
    fuse_dir = task.get("fuse_save_dir") or f"{save_dir}-prep"
    save_modal = bool(task.get("save_modal", True))  # the ua baseline
    save_wav = bool(task.get("save_output_wav", True))  # run-dir wavs, readouts
    compact_params = bool(task.get("save_compact_params", False))
    fuse_keep = np.arange(0, fuse_Nx, fuse_stride) if fuse else None
    # a fresh stride offset per batch, from a generator of its own so the
    # parameter stream (and _gen_meta.jsonl's provenance) stays as it is
    fuse_jitter = bool(task.get("save_x_offset_jitter", False))
    x_off_rng = (np.random.default_rng([int(args.proc.seed), 0x0FF5E7])
                 if fuse and fuse_jitter and fuse_stride > 1 else None)
    if fuse:
        from ..utils import data as udata
        from . import process_training_data as ptd

        os.makedirs(fuse_dir, exist_ok=True)
    if fuse and lead:
        # one provenance line per generation job: the same seed at another
        # batch size draws other strings
        with open(os.path.join(fuse_dir, "_gen_meta.jsonl"), "a") as f:
            f.write(json.dumps({
                "seed": int(args.proc.seed), "batch_size": int(task.batch_size),
                "num_samples": int(n_samples * task.batch_size),
                "save_x_stride": fuse_stride, "save_modal": save_modal,
                "save_x_offset_jitter": fuse_jitter,
                "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }) + "\n")
    collect_state = bool(task.save or task.plot_state or fuse)
    plot_lock = threading.Lock()  # pyplot is not thread-safe
    rescue = bool(task.get("rescue_nan", True)) and task.precision != "double"
    kernel_gmres_on = kernel_gmres_rerun_enabled(task, args)
    Nt_run = int(task.length * sr)
    chunk_r = max(Nt_run if task.chunk_length < 0 else int(task.chunk_length * sr), 3)

    def save_item(b, d, excitation, uout, zout, state_u, state_z, v_r, F_H,
                  u_H, string, bow, hammer, Nx_t, Nx_l, sig0, sig1,
                  bow_mask, hammer_mask, pluck_mask, consts_list, keep, rescued):
        if save_wav or task.save or task.plot or task.plot_state:
            os.makedirs(d, exist_ok=True)
        if save_wav:
            if task.normalize_output:
                u_n, gain = audio.ell_infty_normalize(uout[b])
                z_n = gain * zout[b]
            else:
                u_n, z_n = uout[b], zout[b]
            wavio.write(f"{d}/output-u.wav", u_n, sr, bitrate)
            wavio.write(f"{d}/output-z.wav", z_n, sr, bitrate)
            wavio.write(f"{d}/output.wav", u_n + z_n, sr, bitrate)
        if task.save:
            overall = dict(
                uout=uout[b], zout=zout[b], v_r_out=v_r[b], F_H_out=F_H[b],
                u_H_out=u_H[b], bow_mask=bow_mask[b], hammer_mask=hammer_mask[b],
                pluck_mask=pluck_mask[b], Nx_t=Nx_t[b], Nx_l=Nx_l[b],
                sig0=sig0[b], sig1=sig1[b],
                string_params=[
                    string.kappa[b], string.alpha[b], string.u0[b][None, :],
                    string.v0[b][None, :], string.p_a[b], string.f0[b],
                    string.pos[b], string.T60[b], string.target_f0[b],
                ],
                hammer_params=[
                    hammer.x_H[b], hammer.v_H[b], hammer.u_H[b], hammer.w_H[b],
                    hammer.M_r[b], hammer.alpha[b],
                ],
                bow_params=[
                    bow.x_b[b], bow.v_b[b], bow.F_b[b], bow.phi_0[b],
                    bow.phi_1[b], bow.wid[b],
                ],
            )
            if not fuse:  # the fused bundle is state-free
                overall["state_u"] = state_u[b, :, : int(Nx_t[b].max()) + 1]
                overall["state_z"] = state_z[b, :, : int(Nx_l[b].max()) + 1]
            ms.save_simulation_data(d, excitation, overall, consts_list)
        if task.plot or task.plot_state:
            with plot_lock:
                draw_item(b, d, uout, zout, state_u, state_z, v_r, F_H, u_H, string, bow,
                          hammer, Nx_t, Nx_l)
        if not fuse:
            return
        _sim = dict(bow_mask=bow_mask[b], hammer_mask=hammer_mask[b],
                    pluck_mask=pluck_mask[b], Nx_t=Nx_t[b], Nx_l=Nx_l[b],
                    sig0=sig0[b], sig1=sig1[b])
        if save_wav:
            _sim.update(uout=uout[b], zout=zout[b], v_r_out=v_r[b],
                        F_H_out=F_H[b], u_H_out=u_H[b])
        _str = dict(kappa=string.kappa[b], alpha=string.alpha[b],
                    u0=string.u0[b][None, :], v0=string.v0[b][None, :],
                    p_a=string.p_a[b], f0=string.f0[b], pos=string.pos[b],
                    T60=string.T60[b], target_f0=string.target_f0[b])
        _bow = dict(x_B=bow.x_b[b], v_B=bow.v_b[b], F_B=bow.F_b[b],
                    phi_0=bow.phi_0[b], phi_1=bow.phi_1[b], wid_B=bow.wid[b])
        _ham = dict(x_H=hammer.x_H[b], v_H=hammer.v_H[b], u_H=hammer.u_H[b],
                    w_H=hammer.w_H[b], M_r=hammer.M_r[b], alpha=hammer.alpha[b])
        if state_u.post is not None and b not in rescued:
            # the device path: the item's kept columns and tracks, pulled
            # once per batch, plus the modal data from the host
            t0 = time.perf_counter()
            pz = state_u.post.get()
            stats.time("pull", time.perf_counter() - t0)
            t0 = time.perf_counter()
            item = _assemble_post_item(pz, b, _sim, _str, _bow, _ham, string,
                                       Nx_t, keep, fuse_Nx, sr, save_modal)
            stats.time("assemble", time.perf_counter() - t0)
        else:
            # the host path: the item's state at its native width
            t0 = time.perf_counter()
            _sim["state_u"] = state_u.fetch_element(b, int(Nx_t[b].max()) + 1)
            item = ptd.build_processed(
                _sim, _str, _bow, _ham, theta_t, task.lambda_c, sr, fuse_Nx,
                strict=False, device_synth=False,
                x_keep=keep if fuse_stride > 1 else None)
            if not save_modal:
                for key in ("ua", "ua_f0"):
                    item.pop(key, None)
            stats.time("host_build", time.perf_counter() - t0)
        if compact_params:
            for key in COMPACT_DROP:
                item.pop(key, None)
        t0 = time.perf_counter()
        udata.save(os.path.join(fuse_dir, os.path.basename(d)), item, sr=sr)
        stats.time("write", time.perf_counter() - t0)

    def draw_item(b, d, uout, zout, state_u, state_z, v_r, F_H, u_H, string, bow, hammer,
                  Nx_t, Nx_l):
        """The item's figures (JAX simulate.py:1530-1558).  A fused run's
        state is on the device (its transverse field kept for the video);
        it draws no longitudinal state."""
        def field(st, w):
            if st is None:
                return None
            if isinstance(st, _DeviceState):
                return st.fetch_element(b, w) if task.plot_state else None
            return st[b, :, :w]

        su_b = field(state_u, int(Nx_t[b].max()) + 1)
        if task.plot:
            uplot.simulation_plots(d, uout[b], zout[b], string.target_f0[b], sr)
            uplot.simulation_data(
                d, uout[b], zout[b], v_r[b], F_H[b], u_H[b], su_b,
                field(state_z, int(Nx_l[b].max()) + 1),
                string_params=[
                    string.kappa[b], string.alpha[b], string.u0[b][None, :],
                    string.v0[b][None, :], string.p_a[b], string.f0[b],
                    string.pos[b], string.T60[b], string.target_f0[b],
                ],
                bow_params=[bow.x_b[b], bow.v_b[b], bow.F_b[b], bow.phi_0[b],
                            bow.phi_1[b], bow.wid[b]],
                hammer_params=[hammer.x_H[b], hammer.v_H[b], hammer.u_H[b],
                               hammer.w_H[b], hammer.M_r[b], hammer.alpha[b]],
                sr=sr,
            )
        if task.plot_state:
            uplot.state_video(d, su_b, sr)

    with concurrent.futures.ThreadPoolExecutor(
        max_workers=max(int(args.proc.num_workers), 1)
    ) as pool:
        pending = []
        for it in range(n_samples):
            # bound the in-flight artifact queue to ~one iteration's items
            while len(pending) > task.batch_size:
                pending.pop(0).result()
            dx = str(it) if not task.randomize_name else ms.random_str(rng=rng)
            keep_it = fuse_keep
            if x_off_rng is not None:
                keep_it = np.arange(int(x_off_rng.integers(fuse_stride)),
                                    fuse_Nx, fuse_stride)

            # the float64 engine's wavs after every chunk; the kernel's route
            # ignores it, as the JAX kernel route does
            save_path = f"{save_dir}/{dx}/{sr}" if task.write_during_process else None
            st = time.time()
            ladder = {} if kernel_gmres_on else None
            results, params_out, masks, device = simulate(
                model_name, sr, theta_t, task.length, task.batch_size,
                task.f0_inf, task.alpha_inf, task.lambda_c, args.proc.cpu,
                task.load_config, precision=task.precision,
                relative_order=task.relative_order,
                surface_integral=task.surface_integral,
                randomize_each=task.randomize_each,
                manufactured=task.manufactured, rng=rng,
                collect_state=collect_state,
                postproc_keep=(keep_it, fuse_Nx) if fuse else None,
                keep_state=bool(task.plot_state),
                stats=stats, kernel_gmres=ladder, chunk_length=task.chunk_length,
                save_path=save_path, skip_nan=task.skip_nan, rows=rank_rows, **kw,
            )
            proc_time = time.time() - st

            uout, zout, state_u, state_z, v_r, F_H, u_H, sig0, sig1 = results
            string, bow, hammer, consts_list, sim_c = params_out
            bow_mask, hammer_mask, pluck_mask = masks

            fused_out = torch.is_tensor(uout)
            if fused_out:  # the (B,) NaN flags cross
                state_is_nan = torch.isnan(uout.sum(-1)).cpu().numpy()
                stats.count(state_is_nan.nbytes)
            else:
                state_is_nan = np.isnan(uout.sum(-1))
            # the rescue ladder: stage 1 (the kernel's GMRES re-run) ran in
            # process(); every sample that does not reach disk is attributed
            # to a named cause
            first = state_is_nan if ladder is None else ladder["nan_first_pass"]
            batch_stat = {
                "it": it, "n": len(bow_mask),
                "nan_first_pass": int(first.sum()),
                "rescued_kernel_gmres": int((first & ~state_is_nan).sum()),
                "rescued_f64": 0,
            }
            rescued_set = set()  # spliced strings take the host build
            if rescue and state_is_nan.any():
                # stage 2: the strings still NaN again in float64 on the host
                idx = np.nonzero(state_is_nan)[0]
                print(f"[simulate] f64-rescuing diverged element(s) {idx.tolist()}",
                      flush=True)
                t0 = time.perf_counter()
                r_uout, r_zout, r_su, r_sz, r_vr, r_FH, r_uH, r_s0, r_s1 = \
                    rescue_nan_elements(string, bow, hammer, bow_mask, hammer_mask,
                                        idx, sim_c, Nt_run, chunk_r, sr)
                batch_stat["rescue_f64_s"] = round(time.perf_counter() - t0, 3)
                ok = ~np.isnan(r_uout.sum(-1))
                oki = idx[ok]
                if len(oki):
                    if fused_out:
                        rows = torch.as_tensor(oki, device=uout.device)
                        with torch.inference_mode():  # the plain version's outputs
                            uout[rows] = torch.as_tensor(r_uout[ok], dtype=uout.dtype,
                                                         device=uout.device)
                            zout[rows] = torch.as_tensor(r_zout[ok], dtype=zout.dtype,
                                                         device=zout.device)
                    else:
                        uout[oki] = r_uout[ok]
                        zout[oki] = r_zout[ok]
                    v_r[oki], F_H[oki], u_H[oki] = r_vr[ok], r_FH[ok], r_uH[ok]
                    sig0[oki], sig1[oki] = r_s0[ok], r_s1[ok]
                    if r_su is not None:
                        if isinstance(state_u, _DeviceState):
                            state_u.rescued.update(
                                {int(b): r_su[j] for j, b in zip(np.nonzero(ok)[0], oki)})
                        else:
                            state_u[oki] = r_su[ok]
                            state_z[oki] = r_sz[ok]
                    state_is_nan[oki] = False
                    rescued_set.update(int(b) for b in oki)
                    batch_stat["rescued_f64"] = len(oki)
                    batch_stat["rescue_f64_rows"] = [share.start + int(b) for b in oki]
            if fused_out:
                # the silence flags cross; the readouts only when an
                # artifact holds them
                nan_d = torch.as_tensor(state_is_nan, device=uout.device)
                uout = uout * ~nan_d[:, None]
                rms = torch.sqrt(torch.mean(uout.double() ** 2, dim=-1))
                db = 20 * torch.log10(rms + float(np.finfo(np.float64).eps))
                readouts = (_HostCopy({"uout": uout, "zout": zout}, stats)
                            if save_wav or task.save or task.plot else None)
                is_silent = (db <= task.silence_threshold).cpu().numpy()
                stats.count(is_silent.nbytes)
                uout, zout = _Readout(readouts, "uout"), _Readout(readouts, "zout")
            else:
                uout = uout * ~state_is_nan[:, None]
                is_silent = audio.dB_RMS(uout) <= task.silence_threshold
            _, _, Nx_t, _, Nx_l, _ = fdm.get_derived_vars_host(
                string.f0, string.kappa[:, None], 1.0 / sr, theta_t,
                task.lambda_c, string.alpha[:, None], dtype=np.float32,
            )
            batch_stat["nan_final"] = int(state_is_nan.sum())
            batch_stat["silent"] = int((is_silent & ~state_is_nan).sum())
            batch_stat["written"] = 0
            skipped_detail = []
            for b in range(len(bow_mask)):
                gb = share.start + b  # the string's index in the whole batch
                skipped_here = state_is_nan[b] or (task.skip_silence and is_silent[b])
                if skipped_here:
                    skipped_detail.append({
                        "b": gb,
                        "why": "nan" if state_is_nan[b] else "silent",
                        "f0": round(float(string.f0[b, 2]), 2),
                        "alpha": round(float(string.alpha[b]), 3),
                        "p_a": round(float(string.p_a[b]), 4),
                    })
                if task.get("dump_draws") or (skipped_here and task.get("dump_skipped")):
                    _dump_draw(f"{save_dir}/draw-{dx}-{gb}.npz", b,
                               skipped_detail[-1]["why"] if skipped_here else "kept",
                               string, bow, hammer, bow_mask, hammer_mask, sim_c)
                if skipped_here:
                    continue
                batch_stat["written"] += 1
                excitation = ",".join(
                    t for t, m in (("bow", bow_mask[b]), ("hammer", hammer_mask[b]),
                                   ("pluck", pluck_mask[b]))
                    if m
                )
                pending.append(pool.submit(
                    save_item, b, f"{save_dir}/{dx}-{gb}", excitation, uout,
                    zout, state_u, state_z, v_r, F_H, u_H, string, bow, hammer,
                    Nx_t, Nx_l, sig0, sig1, bow_mask, hammer_mask, pluck_mask,
                    consts_list, keep_it, rescued_set,
                ))
            if skipped_detail:
                batch_stat["skipped"] = skipped_detail
            # the batch over every rank: its slowest rank's time, the
            # counts summed
            parts = mesh.all_gather_objects((proc_time, batch_stat))
            proc_time = max(t for t, _ in parts)
            batch_stat = _merge_batch_stats([b for _, b in parts])
            time_log.append(proc_time)
            del results, state_u, state_z  # the next batch may reuse the memory
            if not lead:
                continue
            log_name = "gpu_time" if device.type == "cuda" else "cpu_time"
            with open(f"{save_dir}/{log_name}.txt", "a") as f:
                f.write(f"{dx}\t{proc_time:.2f}\n")
            if "skipped" in batch_stat:
                print(
                    f"[simulate] batch {it}: wrote {batch_stat['written']}"
                    f"/{task.batch_size} (nan={batch_stat['nan_final']}, "
                    f"silent={batch_stat['silent']})", flush=True,
                )
            skip_stats.append(batch_stat)
            with open(f"{save_dir}/skip_stats.json", "w") as f:
                json.dump(skip_stats, f, indent=1)
        for fut in pending:
            fut.result()
    stats.merge(mesh.all_gather_objects(stats.snapshot()))
    timing = stats.save_timing()
    if timing and lead:
        # as the JAX package: the batches, the writer phases, and here the
        # run's device-to-host bytes, the bytes of the state fields that
        # stayed on the device, and per-batch width spreads
        with open(f"{save_dir}/skip_stats.json", "w") as f:
            json.dump({"batches": skip_stats, "save_timing": timing,
                       "link_bytes": stats.link_bytes,
                       "state_bytes": stats.state_bytes,
                       "width_spread": stats.width_spread}, f, indent=1)
    return time_log
