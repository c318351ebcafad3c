"""``tools/profile_kernel.py``: the per-phase cycle table and the card check.

The tool measures on the CUDA card only (the instrumented kernel and
``torch.profiler``); here, its refusal without a card and its parsing of a
cycle buffer as the instrumented kernel writes it.
"""

import numpy as np
import pytest
import torch

from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
from torch_fdtd_string_tpu_torch.tools import profile_kernel as pk


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pk.profile_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        pk.main(["unused"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        pk.profile_device("cpu")


def test_string_chunked_clocks_refuses_cpu_tensors():
    args, kw = pk.bench_args(2, 0.002, torch.device("cpu"), T=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.string_chunked_clocks(*args, **kw)


def test_phase_table_from_a_synthetic_buffer():
    """A (B, phases + 1) buffer as the instrumented kernel writes it: cycles
    per phase summed over T steps, then the sweep count.  The table is the
    mean per string-step, the shares sum to 1, the text lists the phases
    that ran.  The phases are the one-warp kernel's: each system factored
    once per step, then solved per sweep."""
    assert sk.CLOCK_PHASES == ("step_start", "rhs", "factor_t", "solve_t", "stencil_tl",
                               "factor_l", "solve_l", "stencil_lt", "exit_reduce",
                               "readout", "excitation", "gmres")
    n = len(sk.CLOCK_PHASES)
    T, B = 8, 3
    counts = np.zeros((B, n + 1), np.int64)
    per_step = np.arange(1, n + 1) * 100  # cycles per step of each phase
    counts[:, :n] = per_step * T
    counts[1, :n] *= 3  # a slower string
    counts[:, n] = [2 * T, 3 * T, 2 * T]  # sweeps
    table = pk.phase_table(counts, T)
    mean = per_step * (1 + 3 + 1) / 3
    for name, want in zip(sk.CLOCK_PHASES, mean):
        assert table["cycles"][name] == pytest.approx(want)
    assert table["cycles_per_step"] == pytest.approx(mean.sum())
    assert sum(table["share"].values()) == pytest.approx(1.0)
    assert table["sweeps_per_step"] == pytest.approx(7 / 3)
    text = pk.format_table("a", "synthetic", table)
    assert len(text) == 1 + n and text[0].startswith("[a] synthetic:")
    counts[:, 0] = 0  # a phase that did not run is left out
    assert len(pk.format_table("a", "synthetic", pk.phase_table(counts, T))) == n
    with pytest.raises(ValueError, match="expected"):
        pk.phase_table(counts[:, :n], T)
