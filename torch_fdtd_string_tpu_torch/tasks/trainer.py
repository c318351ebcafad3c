"""Training and evaluation harness of the DMSP synthesizer: the epoch
loop, checkpoints, JSONL metric logging, the score tables and the
code-snapshot delegation.

Port of ``torch_fdtd_string_tpu/tasks/trainer.py`` (reference
``src/trainer.py`` + ``src/callbacks.py``).  ``train`` runs the epoch loop
on the run's device (the card unless ``proc.cpu=true``): batches gathered
from a device cache of the prepared splits when it fits the budget
(``_device_cache``), else prepared by a worker thread and copied ahead of
the step (``_prefetch``); validation on the valid split with the
dataset's modes and on the test split with the estimator's; the best
``valid/loss`` checkpoint marked ``BEST``; ``profile.json`` the scopes'
summary.  ``evaluate`` loads a run's checkpoint, synthesizes every test
item on the run's device, scores the model and the analytic modal
baseline against the FDTD target on that device, and writes
``score/output.txt`` and ``score/modals.txt``; a run directory holding a
code snapshot (``codes/torch_fdtd_string_tpu_torch``, written by
``run.py::backup_code``) is scored by the snapshot's own ``evaluate``.
Checkpoints are ``torch.save`` files under
``<save_dir>/string/ckpt/checkpoints``: ``step_<n>.pt`` holds the model's
parameters and constants, ``optstate_<n>.pt`` beside it the optimizer's
state.  In a multi-rank run (``parallel/mesh.py``) ``train`` is data
parallel, as the JAX package's mesh trains: every rank takes its rows of
each global batch and the gradients are averaged before each step, so a
step equals the single-card step; validation, the logs, ``profile.json``,
the checkpoints and ``BEST`` are rank 0's alone.  With ``task.plot``
``train`` draws each validation's first batch (``callbacks.plot_results``)
and ``evaluate`` the first test batch's spectrograms, or with
``task.plot_test_video`` each test batch's state summary and video.
``evaluate`` also serves a run the JAX package trained: its orbax
checkpoints (``step_<n>/``) are read by ``models/convert.py``.
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import queue
import re
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..core import analytic
from ..data.dataset import DataLoader, Testset, Trainset, _collate
from ..models import optim as optlib
from ..models.convert import load_orbax, state_dict_from_jax
from ..models.losses import build_loss_registry
from ..models.objective import build_metric_registry
from ..parallel import mesh
from ..utils.profiling import Timer
from . import synthesize as S
from ..utils import plot as uplot
from .callbacks import plot_results, plot_state_video, save_results, save_test_results
from .simulate import select_device

PKG = __name__.split(".")[0]
# the device cache's budget in GB (the JAX package's default); the f16
# cache is taken when only it fits, and 0 streams every batch
CACHE_GB = 6.0
HEADER = ["x_grid", "kappa", "alpha", "p_a", "p_x", "si_sdr", "sdr", "logmag", "f0_error"]


def _ckpt_dir(save_dir):
    return os.path.join(save_dir, "string", "ckpt", "checkpoints")


def _log(save_dir, record):
    """Append one JSON line to ``<save_dir>/metrics.jsonl``."""
    def num(v):
        return float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v

    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({k: num(v) for k, v in record.items()}) + "\n")


def _save_atomic(obj, path):
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(save_dir, model, step, optimizer=None):
    """Write ``step_<n>.pt``: the model's parameters and constants (its
    persistent buffers), the inference artifact of a run; with
    ``optimizer``, ``optstate_<n>.pt`` beside it, its state, so that a
    resumed run continues exactly.  Each file is written whole or not at
    all."""
    path = os.path.abspath(os.path.join(_ckpt_dir(save_dir), f"step_{step}.pt"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    constants = {k: v.detach().cpu() for k, v in model.named_buffers()
                 if k in model.state_dict()}
    if optimizer is not None:
        _save_atomic(optimizer.state_dict(), _optstate_path(path, step))
    _save_atomic({"params": params, "constants": constants, "step": int(step)}, path)
    return path


def _optstate_path(ckpt_path, step):
    return os.path.join(os.path.dirname(ckpt_path), f"optstate_{step}.pt")


def load_checkpoint(ckpt_path, model):
    """Load ``ckpt_path`` into ``model`` strictly: no entry left over on
    either side.  A ``step_<n>.pt`` of the port, or a ``step_<n>/``
    directory the JAX package wrote with orbax (``models/convert.py``:
    read by tensorstore, carried by ``state_dict_from_jax``).  Returns the
    step."""
    if os.path.isdir(ckpt_path):
        variables = load_orbax(ckpt_path)
        model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
        return _step(ckpt_path)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict({**ckpt["params"], **ckpt["constants"]}, strict=True)
    return ckpt["step"]


_CKPT = re.compile(r"step_(\d+)(\.pt)?$")


def _step(path):
    return int(_CKPT.match(os.path.basename(path)).group(1))


def _is_checkpoint(path):
    """A port checkpoint file ``step_<n>.pt`` or a JAX checkpoint
    directory ``step_<n>`` (not a file being written, nor orbax's
    temporary directories)."""
    m = _CKPT.match(os.path.basename(path))
    return bool(m) and (os.path.isfile(path) if m.group(2) else os.path.isdir(path))


def latest_checkpoint(run_dir, prefer_best=False):
    """The run's checkpoint (reference trainer.py:21-27): the one a
    ``BEST`` marker names when ``prefer_best`` and it exists, else the
    latest step; in either run layout, the port's (``step_<n>.pt``) or the
    JAX package's (``step_<n>/``, JAX trainer.py:111-130).  Of two of one
    step the port's file is taken."""
    pats = [f"{run_dir}/string/*/checkpoints/step_*", f"{run_dir}/checkpoints/step_*"]
    hits = [h for p in pats for h in glob.glob(p) if _is_checkpoint(h)]
    if not hits:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    for p in pats if prefer_best else []:
        for m in glob.glob(os.path.join(os.path.dirname(p), "BEST")):
            with open(m) as f:
                best = f.read().split()[0]
            for name in (f"step_{best}.pt", f"step_{best}"):
                cand = os.path.join(os.path.dirname(m), name)
                if _is_checkpoint(cand):
                    return cand
    return max(hits, key=lambda h: (_step(h), h.endswith(".pt")))


def _sync(device):
    """Wait for the device's queued work (where the JAX package blocks on a
    result)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _noise_seed(seed, step):
    """The train step's noise seed at ``step``: the run's seed folded with
    the step, as the JAX package folds a resumed run's key."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def _prefetch(iterator, device, depth=2):
    """Overlap host batch preparation and the host-to-device copy with the
    device's compute (the streaming path, when the device cache is off).

    A worker thread takes each prepared numpy batch, pins it and starts
    its copy to the card ``non_blocking`` on a stream of its own; the
    consumer's stream waits for the copy's event before the step uses the
    batch.  On the CPU the worker just makes the tensors.  A worker's
    exception is raised in the loop, never a silently shortened epoch."""
    q = queue.Queue(maxsize=depth)
    end = object()
    err = []
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def worker():
        try:
            for item in iterator:
                if stream is None:
                    q.put((S.to_device(item, device), None))
                    continue
                host = {k: torch.as_tensor(v).pin_memory() for k, v in item.items()}
                with torch.cuda.stream(stream):
                    batch = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                    copied = torch.cuda.Event()
                    copied.record(stream)
                q.put((batch, copied))
        except BaseException as e:  # handed to the consumer, never dropped
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        batch, copied = item
        if copied is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for v in batch.values():
                v.record_stream(current)
        yield batch


def _build_host_cache(dataset, n_modes, block, sr, cache_path=None, drop=(), chunk=4096):
    """Prepare the whole dataset into one host-side dict (and persist it).

    Prepares ``chunk``-item slices and concatenates per key; fields listed
    in ``drop`` are removed before the save (``train`` drops ``analytic``).
    Fields whose rows are identical across items (the time grid) are
    stored as a single row, which the gather broadcasts.  A cache file
    whose row count is not the dataset's (written while the corpus was
    still filling, or at another ``x_stride``) is rebuilt."""
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            prep = {k: z[k] for k in z.files}
        rows = max(v.shape[0] for v in prep.values())
        if rows == len(dataset):
            print(f"[trainer] loaded host cache {cache_path}")
            for k in drop:
                prep.pop(k, None)
            return prep
        print(f"[trainer] STALE host cache {cache_path}: {rows} rows != "
              f"{len(dataset)} items; rebuilding", flush=True)

    n = len(dataset)
    parts = []
    for lo in range(0, n, chunk):
        p = S.prepare_batch(_collate([dataset[i] for i in range(lo, min(lo + chunk, n))]),
                            n_modes, block, sr)
        for k in drop:
            p.pop(k, None)
        parts.append(p)
        if len(parts) % 4 == 0 or lo + chunk >= n:
            print(f"[trainer] host cache build {min(lo + chunk, n)}/{n}", flush=True)
    prep = {}
    for k in parts[0]:
        rows0 = parts[0][k]
        shared = rows0.ndim >= 2 and all(
            not np.ptp(p[k], axis=0).any() and np.array_equal(p[k][:1], rows0[:1])
            for p in parts)
        prep[k] = rows0[:1] if shared else np.concatenate([p[k] for p in parts])
    if cache_path:
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"
        np.savez(tmp, **prep)
        os.replace(tmp, cache_path)
        print(f"[trainer] wrote host cache {cache_path}")
    return prep


def _device_cache(dataset, n_modes, block, sr, device, drop=(), cache_path=None, f16=False):
    """Upload the whole prepared dataset to ``device`` once; returns
    ``(gather, n)``, ``gather(idx)`` assembling a batch there with
    ``index_select``.  Fields identical across items are stored once and
    broadcast; with ``f16`` the waveform-scale float fields (8 KiB or more
    per item) are stored in half precision and upcast in the gather
    (~-60 dB relative noise, under the corpus's PCM_16 floor).
    ``gather.nbytes`` and ``gather.seconds`` record the cache's size and
    the time to build and upload it."""
    t0 = time.perf_counter()
    prep = _build_host_cache(dataset, n_modes, block, sr, cache_path, drop)
    n = len(dataset)
    shared, full = {}, {}
    big = 8192
    for k, v in prep.items():
        if v.ndim >= 2 and v.shape[0] == 1 and n > 1:
            shared[k] = torch.as_tensor(v, device=device)
        elif v.ndim >= 2 and v.shape[0] == n and not np.ptp(v, axis=0).any():
            shared[k] = torch.as_tensor(v[:1], device=device)
        elif f16 and v.dtype == np.float32 and v.nbytes // max(v.shape[0], 1) >= big:
            full[k] = torch.as_tensor(v.astype(np.float16), device=device)
        else:
            full[k] = torch.as_tensor(v, device=device)

    def gather(idx):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)
        out = {k: v.index_select(0, idx).float() if v.dtype == torch.float16
               else v.index_select(0, idx) for k, v in full.items()}
        for k, v in shared.items():
            out[k] = v.expand((idx.shape[0],) + tuple(v.shape[1:]))
        return out

    _sync(device)
    gather.seconds = time.perf_counter() - t0
    gather.nbytes = sum(v.numel() * v.element_size()
                        for v in list(full.values()) + list(shared.values()))
    print(f"[trainer] device-cached {n} samples ({gather.nbytes / 1e6:.0f} MB in "
          f"{gather.seconds:.1f}s; shared: {sorted(shared)})", flush=True)
    return gather, n


def _eval_sweep(eval_fn, gather_fn, n_items, bs, seed, device, on_first=None):
    """Batched eval over a device-cached split, with an out-of-memory
    backoff: the eval's scratch lives beside the resident train cache, so
    a large eval batch can run out of device memory where the train step
    fits.  Gathered batches are cheap and deterministic to re-make, so on
    ``torch.cuda.OutOfMemoryError`` the whole sweep restarts at half the
    batch; the working size is returned for the next epoch.  Every batch's
    noise comes from a generator seeded ``seed`` (the JAX sweep reuses one
    key)."""
    while True:
        try:
            vals = []
            for vi, lo in enumerate(range(0, n_items, bs)):
                hi = min(lo + bs, n_items)
                generator = torch.Generator(device=device).manual_seed(seed)
                outputs, ld = eval_fn(gather_fn(np.arange(lo, hi)), generator)
                d = {k: float(v) for k, v in ld.items()}
                # split means weigh batches by their items, so that an
                # OOM-halved batch does not move the BEST selection
                d["_n"] = hi - lo
                vals.append(d)
                if vi == 0 and on_first is not None:
                    on_first(outputs)
            return vals, bs
        except torch.cuda.OutOfMemoryError:
            if bs <= 1:
                raise
            bs //= 2
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            print(f"[trainer] eval sweep out of memory; retrying at batch {bs}", flush=True)


def _stream_sweep(eval_fn, loader, n_modes, block, sr, seed, device, on_first=None):
    """The eval sweep of a split that is not device-cached."""
    vals = []
    for vi, batch in enumerate(loader):
        prep = S.prepare_batch(batch, n_modes, block, sr)
        generator = torch.Generator(device=device).manual_seed(seed)
        outputs, ld = eval_fn(S.to_device(prep, device), generator)
        vals.append(dict({k: float(v) for k, v in ld.items()}, _n=len(prep["gt"])))
        if vi == 0 and on_first is not None:
            on_first(outputs)
    return vals


def _host_items(outputs, n=None):
    """The first ``n`` items (all without ``n``) of each output, as numpy."""
    return {k: v[:n].detach().cpu().numpy() for k, v in outputs.items()}


def _wmean(vals, prefix):
    """Item-weighted split means from per-batch loss dicts ('_n' weights;
    dicts without '_n' weigh batches equally)."""
    if not vals:
        return {}
    w = np.asarray([v.get("_n", 1) for v in vals], np.float64)
    return {f"{prefix}/{k}": float(np.sum([v[k] * wi for v, wi in zip(vals, w)]) / w.sum())
            for k in vals[0] if k != "_n"}


def build_training(args, device, total_steps, dtype=None, sharded=None):
    """What :func:`train` trains with, from the config: the model (its
    weights drawn from ``proc.seed``, in ``dtype`` when given), the
    optimizer and its schedule (over ``total_steps``), the loss registry,
    the criteria and the train step.  ``sharded`` (a multi-rank run's
    default) makes the step data parallel on this rank's rows of every
    global batch of ``task.batch_size``, its ``f0`` loss on the global
    batch's statistics.  Returns a namespace of these."""
    task = args.task
    sr = task.sr
    trim = int(task.train_lens * sr) if task.train_lens else None
    if sharded is None:
        sharded = mesh.world_size() > 1
    registry = build_loss_registry(sr, trim or sr)
    criteria = list(task.loss_criteria)
    gc = task.grad_clip
    grad_clip = gc[0] if isinstance(gc, (list, tuple)) and gc and gc[0] else None
    model = S.build_model(args, generator=torch.Generator().manual_seed(int(args.proc.seed)),
                          device=device)
    if dtype is not None:
        model = model.to(dtype)
    sched = args.get("scheduler")
    optimizer, schedule, needs_value = optlib.build(
        model.parameters(), args.optimizer._name_, dict(args.optimizer),
        sched.get("_name_") if sched else None, dict(sched or {}), grad_clip,
        total_steps=total_steps)
    train_step = S.make_train_step(
        model, optimizer,
        build_loss_registry(sr, trim or sr, sharded=True) if sharded else registry,
        criteria, model.inharmonic, needs_value,
        shard=(mesh.shard_rows(task.batch_size), task.batch_size) if sharded else None)
    return SimpleNamespace(model=model, optimizer=optimizer, schedule=schedule,
                           registry=registry, criteria=criteria, train_step=train_step)


def train_state(model, optimizer, seed, step, device):
    """The ``TrainState`` of a run at ``step``: its noise generator seeded
    from the run's seed and the step."""
    return S.TrainState(model, optimizer, step,
                        torch.Generator(device=device).manual_seed(_noise_seed(seed, step)))


def train(args, save_dir):
    """The epoch loop (reference trainer.py + the LightningModule's
    training and validation steps).  The splits are cached on the device
    when they fit ``CACHE_GB`` (in half precision when only that fits; per
    rank, each of which caches the whole train split), else every batch is
    streamed.  With several ranks each takes its rows (``shard_rows``) of
    every global batch of ``task.batch_size``, which must divide by the
    world size; rank 0 alone validates and writes.  Returns the final
    ``TrainState``."""
    task = args.task
    if task.get("plot"):
        uplot.require("task.plot")
    rows = mesh.shard_rows(task.batch_size)  # refused before anything runs
    sharded = mesh.world_size() > 1
    lead = mesh.rank() == 0
    device = select_device(args.proc.cpu)
    os.makedirs(save_dir, exist_ok=True)
    seed = int(args.proc.seed)
    block, sr = args.model.block_size, task.sr
    trim = int(task.train_lens * sr) if task.train_lens else None
    data_dir = task.load_dir
    x_stride = int(task.get("x_stride", 1) or 1)
    trainset = Trainset(data_dir, task.load_name, trim=trim, x_stride=x_stride)
    validset = Testset(data_dir, task.load_name, split="valid", x_stride=x_stride)
    train_loader = DataLoader(trainset, task.batch_size, shuffle=True, drop_last=True, seed=seed)
    valid_loader = DataLoader(validset, task.valid_batch_size, shuffle=False)
    # dual-loader validation (reference validation_step runs valid AND test
    # each epoch, synthesize.py:333-383); BEST stays keyed on valid/loss
    try:
        testset = Testset(data_dir, task.load_name, split="test", x_stride=x_stride)
        test_loader = DataLoader(testset, task.valid_batch_size, shuffle=False)
    except FileNotFoundError:
        testset = test_loader = None

    # schedules decay over the real horizon (epochs x steps per epoch)
    steps_per_epoch = max(len(trainset) // task.batch_size, 1)
    total_steps = int(task.total_epoch) * steps_per_epoch

    # the first batch, as the JAX package takes it: it advances the
    # loader's shuffle, and gives the item length
    first = next(iter(train_loader))
    setup = build_training(args, device, total_steps)
    model, optimizer, schedule = setup.model, setup.optimizer, setup.schedule
    registry, criteria = setup.registry, setup.criteria
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[trainer] params: {n_params / 1e6:.2f}M; criteria: {criteria}; device {device}"
          + (f"; rank {mesh.rank()} of {mesh.world_size()}, rows {rows.start}:{rows.stop} "
             f"of each batch of {task.batch_size}" if sharded else ""))

    # every rank loads the same checkpoint; the broadcast keeps the ranks'
    # weights one even where a build or a load could differ
    start_step = restore(save_dir, model, optimizer) if task.get("resume") else 0
    mesh.replicate(model)
    state = train_state(model, optimizer, seed, start_step, device)
    inharmonic = model.inharmonic
    train_step = setup.train_step
    eval_step = S.make_eval_step(model, registry, criteria, inharmonic)
    # the test split synthesizes from the estimator's modes (reference
    # validation_step feeds [.., None, None] for dataloader_idx != 0)
    eval_step_est = S.make_eval_step(model, registry, criteria, inharmonic, use_gt_modes=False)

    # device-cache the splits when items are deterministic (no random trim)
    # and the cache fits the budget; else stream host batches.  Per item the
    # audio-length target dominates; the other fields add ~20%
    item_len = first["target"].shape[-1]
    est_gb = len(trainset) * 1.2 * item_len * 4 / 1e9
    cache_f16 = CACHE_GB < est_gb <= 2 * CACHE_GB
    if cache_f16:
        est_gb /= 2
        print(f"[trainer] f32 device cache over budget -> f16 cache "
              f"({est_gb:.1f} GB <= {CACHE_GB:.0f} GB)")
    cacheable = (trim is None or trim >= item_len) and est_gb <= CACHE_GB
    if not cacheable:
        print(f"[trainer] device cache off (est {est_gb:.1f} GB > {CACHE_GB:.0f} GB or "
              "random trim active) -> streaming path")

    prof = Timer()
    gather = vgather = tgather = None
    n_test = 0
    if cacheable:
        # every knob that changes the prepared item set is in the tag, so
        # that a host cache of another set is never gathered from
        ctag = f"{model.n_modes}_{block}_{sr}_{trim or 0}_x{x_stride}"

        def cache(ds, split):
            with prof.scope("device_cache"):
                return _device_cache(ds, model.n_modes, block, sr, device, drop=("analytic",),
                                     cache_path=os.path.join(data_dir, task.load_name,
                                                             f"_prep_{split}_{ctag}.npz"),
                                     f16=cache_f16)

        # rank 0 writes the host cache, the other ranks load it
        with mesh.rank_zero_first():
            gather, n_train = cache(trainset, "train")
        if lead:  # only rank 0 validates
            vgather, n_valid = cache(validset, "valid")
            if testset is not None:
                tgather, n_test = cache(testset, "test")
        # a fresh generator each run: a resumed run's first epoch replays
        # epoch 0's order, as the JAX package's does (ROADMAP: known
        # reference faults)
        shuffle_rng = np.random.default_rng(seed)

    step = start_step
    best_val = float("inf")
    eval_bs = int(task.valid_batch_size)
    test_bs = int(task.get("test_batch_size") or task.valid_batch_size)
    best_marker = os.path.join(_ckpt_dir(save_dir), "BEST")
    if start_step and os.path.exists(best_marker):
        # a resumed run must not demote the recorded best on its first
        # validation; the marker holds "step<TAB>valid_loss"
        with open(best_marker) as f:
            parts = f.read().split()
        if len(parts) > 1:
            best_val = float(parts[1])
    n_modes = model.n_modes
    for epoch in range(start_step // steps_per_epoch, task.total_epoch):
        t0 = time.time()
        model.train()
        if gather is not None:
            order = shuffle_rng.permutation(n_train)
            nb = n_train // task.batch_size  # drop_last
            batch_iter = (gather(order[i * task.batch_size:(i + 1) * task.batch_size][rows])
                          for i in range(nb))
        else:
            batch_iter = _prefetch((S.prepare_batch(mesh.shard_batch(b, task.batch_size),
                                                    n_modes, block, sr)
                                    for b in train_loader), device)
        with prof.scope("train_epoch"):
            for prep in batch_iter:
                with prof.scope("train_step"):
                    state, loss_dict = train_step(state, prep)
                step = state.step
                if step <= 3 or step % 200 == 0:
                    _sync(device)
                    print(f"[trainer] step {step} done @ {time.time() - t0:.1f}s "
                          f"(epoch {epoch})", flush=True)
                if step % 50 == 0 and lead:
                    rec = {"epoch": epoch, "step": step, "split": "train",
                           "lr": float(schedule(step))}
                    rec.update({f"train/{k}": float(v) for k, v in loss_dict.items()})
                    _log(save_dir, rec)
        if (epoch + 1) % max(task.valid_epoch, 1) != 0:
            continue
        if not lead:
            mesh.barrier()  # rank 0 validates and writes
            continue
        model.eval()
        eval_seed = 1234 + epoch

        def plot_first(outputs):
            # JAX trainer.py:566-592: the first valid batch's first items
            plot_results(save_dir, "valid", _host_items(outputs, 4), sr, step=step)

        on_first = plot_first if task.get("plot") else None
        with prof.scope("valid_sweep"):
            if vgather is not None:
                vals, eval_bs = _eval_sweep(eval_step, vgather, n_valid, eval_bs, eval_seed,
                                            device, on_first=on_first)
            else:
                vals = _stream_sweep(eval_step, valid_loader, n_modes, block, sr, eval_seed,
                                     device, on_first=on_first)
        mean = _wmean(vals, "valid")
        mean.update({"epoch": epoch, "step": step, "split": "valid",
                     "lr": float(schedule(step)), "epoch_time": time.time() - t0})
        _log(save_dir, mean)
        print(f"[trainer] epoch {epoch} step {step} "
              + " ".join(f"{k}={v:.4f}" for k, v in mean.items() if isinstance(v, float)))
        # the test split each validation epoch too (reference
        # synthesize.py:333-383), with its own batch size
        if testset is not None:
            with prof.scope("test_sweep"):
                if tgather is not None:
                    tvals, test_bs = _eval_sweep(eval_step_est, tgather, n_test, test_bs,
                                                 eval_seed, device)
                else:
                    tvals = _stream_sweep(eval_step_est, test_loader, n_modes, block, sr,
                                          eval_seed, device)
            if tvals:
                tmean = _wmean(tvals, "test")
                tmean.update({"epoch": epoch, "step": step, "split": "test"})
                _log(save_dir, tmean)
        vloss = mean.get("valid/loss", float("inf"))
        # a periodic checkpoint independent of the best validation, so a
        # long run resumes from a recent epoch
        ckpt_every = int(task.get("ckpt_every", 0) or 0)
        if ckpt_every and (epoch + 1) % ckpt_every == 0:
            save_checkpoint(save_dir, model, step, optimizer)
        if vloss <= best_val:
            best_val = vloss
            save_checkpoint(save_dir, model, step, optimizer)
            # evaluate() scores the best-validation parameters (reference:
            # Lightning ModelCheckpoint monitor='valid/loss')
            with open(best_marker, "w") as f:
                f.write(f"{step}\t{vloss}")
        mesh.barrier()
    if lead:
        save_checkpoint(save_dir, model, step, optimizer)
        prof.dump(os.path.join(save_dir, "profile.json"))
    mesh.barrier()  # the last checkpoint is whole before any rank reads it
    return state


def restore(save_dir, model, optimizer):
    """Load the run's latest checkpoint into ``model`` and its
    ``optstate`` into ``optimizer`` (or fast-forward the optimizer's count
    when there is none); returns the step."""
    ckpt = latest_checkpoint(save_dir)
    if os.path.isdir(ckpt):
        raise NotImplementedError(
            f"{ckpt} is a JAX (orbax) checkpoint: resuming a JAX run is not ported "
            "(ROADMAP.md); tools/convert_orbax.py makes a run the port scores")
    step = load_checkpoint(ckpt, model)
    opt_path = _optstate_path(ckpt, step)
    if os.path.isfile(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location="cpu", weights_only=True))
    else:
        # the moments start at zero, but the schedule and the bias
        # corrections go on from the step (JAX _fast_forward_opt_counts), so
        # the learning rate applied is the schedule(step) logged
        print(f"[trainer] WARNING: {opt_path} missing - optimizer moments reset; "
              f"fast-forwarding the optimizer's count to {step}")
        optimizer.set_count(step)
    print(f"[trainer] resumed from {ckpt} (step {step})")
    return step


def _in_pkg(name):
    return name == PKG or name.startswith(PKG + ".")


def use_snapshot_code(run_dir):
    """Import the port from the run's code snapshot from now on, when
    there is one (reference trainer.py:85-88 imports ``codes.src...``):
    ``<run_dir>/codes`` goes to the front of ``sys.path`` (once: a second
    call does not grow it) and the port's modules leave ``sys.modules``.
    Returns whether there was a snapshot."""
    codes = os.path.join(run_dir, "codes")
    if not os.path.isdir(os.path.join(codes, PKG)):
        return False
    if codes in sys.path:
        sys.path.remove(codes)
    sys.path.insert(0, codes)
    for name in [m for m in sys.modules if _in_pkg(m)]:
        del sys.modules[name]
    return True


def _snapshot_evaluate(run_dir, args, save_dir):
    """``evaluate`` of the run's snapshot, so that every symbol resolves
    within one code generation (a snapshot taken before a model argument
    came in must not meet the live ``build_model``); ``sys.path`` and the
    port's modules are put back afterwards."""
    saved_path = list(sys.path)
    saved = {k: v for k, v in sys.modules.items() if _in_pkg(k)}
    cache_dir = analytic.CACHE_DIR
    try:
        use_snapshot_code(run_dir)
        snapshot = importlib.import_module(__name__)
        # the snapshot reads and fills the checkout's tables (each file is
        # named by its grid), not a cache of its own under the run directory
        importlib.import_module(f"{PKG}.core.analytic").CACHE_DIR = cache_dir
        return snapshot.evaluate(args, save_dir)
    finally:
        sys.path[:] = saved_path
        for name in [m for m in sys.modules if _in_pkg(m)]:
            del sys.modules[name]
        sys.modules.update(saved)


def _is_snapshot_of(run_dir):
    """Whether this module is imported from ``run_dir``'s snapshot."""
    snap = os.path.realpath(os.path.join(run_dir, "codes", PKG))
    return os.path.realpath(__file__).startswith(snap + os.sep)


def evaluate(args, save_dir):
    """Test loop: model + analytic-modal baseline scores (reference
    synthesize.py:385-476 + callbacks.py SaveTestResults).  Returns the
    model's and the baseline's score rows.  A run directory with a code
    snapshot is scored by the snapshot's ``evaluate``."""
    run_dir = args.task.ckpt_dir or save_dir
    if os.path.isdir(os.path.join(run_dir, "codes", PKG)) and not _is_snapshot_of(run_dir):
        return _snapshot_evaluate(run_dir, args, save_dir)
    task = args.task
    if task.get("plot") or task.get("plot_test_video"):
        uplot.require("task.plot" if task.get("plot") else "task.plot_test_video")
    device = select_device(args.proc.cpu)
    model = S.build_model(args, generator=torch.Generator().manual_seed(args.proc.seed))
    ckpt = latest_checkpoint(run_dir, prefer_best=True)
    load_checkpoint(ckpt, model)
    model = model.to(device).eval()
    block, sr = args.model.block_size, task.sr

    testset = Testset(task.load_dir, task.load_name, split="test",
                      x_stride=int(task.get("x_stride", 1) or 1))
    test_loader = DataLoader(testset, task.test_batch_size, shuffle=False)
    registry = build_loss_registry(sr, sr)
    criteria = [c for c in task.loss_criteria if c in registry]
    # the test step synthesizes from the estimator's modes unless
    # model.use_precomputed_mode (synthesize.py:409-410; dmsp.yaml: false)
    upm = bool(args.model.get("use_precomputed_mode", False))
    eval_step = S.make_eval_step(model, registry, criteria, model.inharmonic,
                                 use_gt_modes=upm)
    metric_registry = build_metric_registry(sr)
    eval_criteria = [c for c in task.get("eval_criteria", []) if c in metric_registry]

    out_rows, mod_rows, ids = [], [], []
    for bi, batch in enumerate(test_loader):
        prep = S.prepare_batch(batch, model.n_modes, block, sr)
        dprep = S.to_device(prep, device)
        generator = torch.Generator(device=device).manual_seed(bi)
        outputs, _ = eval_step(dprep, generator)
        n = outputs["preds"].shape[-1]
        # scored on the model's device, float64; the modal baseline uses its
        # own pitch track ua_f0 (reference synthesize.py:421-426)
        model_scores = S.summarize_eval_scores(prep, outputs["preds"], outputs["target"],
                                               outputs["preds_f0"], prep["gt_f0"], sr)
        modal_scores = S.summarize_eval_scores(prep, dprep["analytic"][..., :n],
                                               outputs["target"],
                                               prep.get("an_f0", prep["gt_f0"]),
                                               prep["gt_f0"], sr)
        # running metric accumulators (torchmetrics dist_reduce_fx="sum")
        for c in eval_criteria:
            metric, keys = metric_registry[c]
            metric.update(*[outputs[k] for k in keys])
        for i in range(len(prep["gt"])):
            ids.append(f"0-{bi}-{i}")
            out_rows.append([float(model_scores[k][i]) for k in HEADER])
            mod_rows.append([float(modal_scores[k][i]) for k in HEADER])
        # flush partial tables every few batches: a crash mid-scoring keeps
        # the rows already scored, under names no consumer takes for final
        if bi % 8 == 7:
            save_test_results(save_dir, out_rows, HEADER, name="output.partial", ids=ids,
                              partial=True)
            save_test_results(save_dir, mod_rows, HEADER, name="modals.partial", ids=ids,
                              partial=True)
        if task.get("plot_test_video"):
            # the test batch is the spatial axis of one string (reference
            # callbacks.py:137-179 PlotStateVideo.summary; JAX trainer.py:749-759)
            gain = prep.get("gain", np.ones((1, 1)))
            host = _host_items(outputs)
            plot_state_video(os.path.join(save_dir, "state"), (host["preds"] * gain).T,
                             (prep["analytic"][..., :n] * gain).T,
                             (host["target"] * gain).T, sr, name=f"0-{bi}")
        elif bi == 0 and task.get("plot"):
            # JAX trainer.py:760-775
            host = _host_items(outputs, 4)
            uplot.rainbowgram(os.path.join(save_dir, "test_pred_spec.pdf"), host["preds"][0],
                              sr)
            uplot.rainbowgram(os.path.join(save_dir, "test_target_spec.pdf"),
                              host["target"][0], sr)
            uplot.est_tar_specs(os.path.join(save_dir, "test_specs"), host["preds"],
                                host["target"], prep["analytic"][:4, :n], sr)
        if task.get("save_results"):
            save_results(os.path.join(save_dir, "eval", str(task.load_name)),
                         outputs["preds"].cpu().numpy(), sr,
                         ids=[f"0-{bi}-{i}" for i in range(len(prep["gt"]))])

    save_test_results(save_dir, out_rows, HEADER, name="output", ids=ids)
    save_test_results(save_dir, mod_rows, HEADER, name="modals", ids=ids)
    for leftover in ("output.partial.txt", "modals.partial.txt"):
        p = os.path.join(save_dir, "score", leftover)
        if os.path.exists(p):
            os.remove(p)
    if eval_criteria:
        rec = {"split": "test"}
        rec.update({f"test/{c}": metric_registry[c][0].compute() for c in eval_criteria})
        _log(save_dir, rec)
        print("[trainer] test metrics: " + " ".join(
            f"{c}={metric_registry[c][0].compute():.4f}" for c in eval_criteria))
    print(f"[trainer] wrote scores for {len(out_rows)} items -> "
          f"{os.path.join(save_dir, 'score')}")
    return out_rows, mod_rows
