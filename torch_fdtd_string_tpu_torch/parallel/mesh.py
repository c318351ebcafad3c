"""Data parallelism over ranks: one process per card, ``torch.distributed``.

Port of ``torch_fdtd_string_tpu/parallel/mesh.py``.  Where the JAX package
lays a 1-D device mesh over the chips and shards the batch axis of global
arrays, the port runs one process (rank) per card, each holding its own
contiguous rows of every global batch:

* dataset generation: every rank draws the whole batch from the same
  seeded generator and simulates its rows (:func:`shard_rows`) on its own
  card; no collective but the job-level statistics that rank 0 writes;
* DMSP training: every rank takes its rows of each global batch, and the
  gradients are averaged over the ranks before the optimizer's step
  (:func:`all_reduce_grads`), so a step equals the single-card step on the
  global batch.

Launch with ``torchrun --nproc_per_node=N -m torch_fdtd_string_tpu_torch.run
...`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or set the JAX package's ``FDTD_COORD=host:port``,
``FDTD_NPROCS`` and ``FDTD_PROC_ID`` in each process.  Without them, or
with one process, nothing here starts a group and every function acts as
on one card.

Departures from the JAX module, on purpose (ROADMAP, known faults in the
reference): every rank trains on its own rows of the global batch, never
the whole batch on each process (``mesh.py:25``), and a batch that does not
divide by the world size is refused, never replicated (``mesh.py:83``).
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# rank 0's validation sweeps, checkpoints and scoring run while the other
# ranks wait at a barrier; NCCL's default of 10 minutes would end them
TIMEOUT = datetime.timedelta(hours=2)


def init_distributed(coordinator=None, num_processes=None, process_id=None, *,
                     cpu=False, backend=None):
    """Join the process group of a multi-process run; returns whether this
    process is one of several ranks.

    The coordinator (``host:port``), the process count and this process's
    id come from the arguments, else ``FDTD_COORD`` / ``FDTD_NPROCS`` /
    ``FDTD_PROC_ID``, else torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``.  With one process it returns False and
    starts nothing.  The card is ``LOCAL_RANK`` (else the id modulo the
    host's cards), made current before the group exists; a rank that finds
    no card raises.  ``backend`` defaults to ``nccl`` on the card and
    ``gloo`` with ``cpu`` (``proc.cpu=true``); ``gloo`` on the card runs
    several ranks on one card, which NCCL refuses.  A group that exists
    already is kept.  A failed ``init_process_group`` raises.
    """
    env = os.environ.get
    if num_processes is None:
        num_processes = env("FDTD_NPROCS") or env("WORLD_SIZE") or 1
    if process_id is None:
        process_id = env("FDTD_PROC_ID") or env("RANK") or 0
    num_processes, process_id = int(num_processes), int(process_id)
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes <= 1:
        return False
    if coordinator is None:
        coordinator = env("FDTD_COORD")
    if coordinator is None and env("MASTER_ADDR") and env("MASTER_PORT"):
        coordinator = f"{env('MASTER_ADDR')}:{env('MASTER_PORT')}"
    if not coordinator:
        raise ValueError(f"{num_processes} processes and no coordinator: set FDTD_COORD "
                         "(host:port) or launch with torchrun")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside {num_processes} processes")
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {process_id} finds no CUDA card; pass proc.cpu=true "
                               "to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        local = int(env("LOCAL_RANK", process_id % n_cards))
        if local >= n_cards:
            raise RuntimeError(f"rank {process_id}: LOCAL_RANK {local} but the host has "
                               f"{n_cards} card(s)")
        torch.cuda.set_device(local)
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return True


def destroy():
    """Leave the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(cpu=False):
    """The device of this rank's work: the CPU with ``cpu``, else in a
    multi-rank run the rank's card by index (``cuda:<LOCAL_RANK>``, made
    current by :func:`init_distributed`) and ``cuda`` on one.  Raises when
    no card is usable."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("this run needs a CUDA card and torch finds none; pass "
                           "proc.cpu=true to run on the CPU")
    if world_size() > 1:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


def shard_rows(B, rank_=None, world=None):
    """This rank's contiguous rows of a global batch of ``B``, a slice;
    raises ``ValueError`` unless ``B`` divides by the world size."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if B % w:
        raise ValueError(f"batch_size {B} does not divide by the world size {w}: every "
                         f"rank needs the same number of rows; set task.batch_size to a "
                         f"multiple of {w}")
    n = B // w
    return slice(r * n, (r + 1) * n)


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, B, rank_=None, world=None):
    """This rank's rows of every tensor or array leaf whose leading
    dimension is ``B``; other leaves as they are (JAX ``shard_batch``)."""
    rows = shard_rows(B, rank_, world)

    def take(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1 and x.shape[0] == B:
            return x[rows]
        return x

    return _map(take, tree)


def _staged(x, op):
    """``op(x)`` in place; under ``gloo`` a CUDA tensor goes through a host
    copy, explicitly, so that no collective depends on what gloo supports
    on the card."""
    if x.is_cuda and dist.get_backend() == "gloo":
        host = x.cpu()
        op(host)
        x.copy_(host)
    else:
        op(x)
    return x


def all_reduce(x, mean=False):
    """Sum (or average) ``x`` over the ranks, in place; returns it.  Like
    every collective here, a no-op outside a process group."""
    if dist.is_initialized():
        _staged(x, dist.all_reduce)
        if mean:
            x /= world_size()
    return x


def all_reduce_grads(params):
    """Average the gradients of ``params`` over the ranks in one collective:
    after it every rank holds the global batch's gradient (equal shards,
    losses that are means over the batch).  Parameters without a gradient
    are skipped on every rank alike."""
    grads = [p.grad for p in params if p.grad is not None]
    if not dist.is_initialized() or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(flat, mean=True)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def replicate(obj):
    """Broadcast rank 0's tensors to every rank, in place: a module's
    parameters and buffers, or the tensor leaves of a tree.  Returns
    ``obj``."""
    if not dist.is_initialized():
        return obj
    tensors = []
    if isinstance(obj, torch.nn.Module):
        tensors = [t.data for t in list(obj.parameters()) + list(obj.buffers())]
    else:
        _map(lambda x: tensors.append(x) if isinstance(x, torch.Tensor) else None, obj)
    for t in tensors:
        _staged(t, lambda x: dist.broadcast(x, src=0))
    return obj


def all_gather_rows(x):
    """Every rank's ``x`` (each ``(n, ...)``, one shape on every rank)
    stacked in rank order along the rows: the inverse of
    :func:`shard_batch`."""
    if not dist.is_initialized():
        return x
    src = x.cpu() if x.is_cuda and dist.get_backend() == "gloo" else x
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src.contiguous())
    return torch.cat(parts).to(x.device)


def all_gather_objects(obj):
    """Every rank's picklable ``obj``, a list in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier():
    if dist.is_initialized():
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first():
    """Rank 0 runs the block first, the others after it: for work that fills
    a file cache (the kernel build, a host cache), so that one rank builds
    and the others load."""
    if rank() != 0:
        barrier()
    yield
    if rank() == 0:
        barrier()
