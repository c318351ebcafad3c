"""Wall-clock scopes and profiler traces.

Port of ``torch_fdtd_string_tpu/utils/profiling.py``: ``Timer``, the named
accumulating scopes whose summary ``tasks/trainer.py::train`` dumps to
``profile.json`` (the reference's Lightning "simple" profiler,
trainer.py:68); ``device_timer``, a wall-clock scope that waits for the
card's queued work before it reads the clock (the reference times its
batches with CUDA events and ``time.time``, simulate.py:278-331); and
``trace``, a ``torch.profiler`` scope that writes a Chrome trace (open it
in Perfetto or ``chrome://tracing``) where the JAX package writes a
``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def device_timer(name, log=None, sync=True):
    """Wall-clock a block; with ``sync``, once the card's queued work is
    done (``torch.cuda.synchronize``, where this process uses CUDA).  The
    seconds are appended to ``log[name]`` when ``log`` is given."""
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if log is not None:
        log.setdefault(name, []).append(dt)


@contextlib.contextmanager
def trace(log_dir):
    """A ``torch.profiler.profile`` scope over the CPU and, where there is
    one, the CUDA card; yields the profiler (``key_averages()`` by kernel)
    and writes the Chrome trace ``<log_dir>/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Accumulating named wall-clock scopes (the reference's Lightning
    'simple' profiler, trainer.py:68).  A scope times what the host spends
    in it: device work it queues counts only where the host waits for it."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def scope(self, name):
        t0 = time.perf_counter()
        yield
        self.times[name].append(time.perf_counter() - t0)

    def summary(self):
        return {
            name: {"count": len(vals), "total_s": sum(vals),
                   "mean_s": sum(vals) / max(len(vals), 1)}
            for name, vals in self.times.items()
        }

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
        return path
