"""Wall-clock scopes.

Port of ``Timer`` from ``torch_fdtd_string_tpu/utils/profiling.py``: the
named accumulating scopes whose summary ``tasks/trainer.py::train`` dumps
to ``profile.json`` (the reference's Lightning "simple" profiler,
trainer.py:68).  The JAX module's ``device_timer`` and ``trace`` are not
ported (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


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
