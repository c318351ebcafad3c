"""Evaluation artifact writers.

Port of the score and wave writers of
``torch_fdtd_string_tpu/tasks/callbacks.py`` (reference ``src/callbacks.py``
``SaveTestResults`` / ``SaveResults``): plain files under the run
directory.  The plot panels and the state video wait for the plots
(ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import wav as wavio


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
