"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``build/kernels/lib<name>.so``
under the repository root, on first use in a process, and loaded with
``ctypes``.  A library newer than its source is reused.  The sources include
no PyTorch header, so a build takes seconds.  A variant of a source built
with preprocessor defines (an instrumented build) is a library of its own
name.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions round them, so kernel and plain version differ only
in summation order.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIBS = {}  # name -> ctypes.CDLL, loaded once per process
build_seconds = {}  # name -> wall seconds of the nvcc run, when one ran
build_log = {}  # name -> nvcc's messages (ptxas registers and spills per kernel)


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source on first "
            "use and need the CUDA toolkit")
    return nvcc


def build_kernel_library(name, source=None, defines=()):
    """Compile ``csrc/<source>.cu`` (``source`` defaults to ``name``) with
    ``-D`` of each of ``defines`` into ``lib<name>.so`` unless an up-to-date
    library exists; return the library's path."""
    src = os.path.join(CSRC_DIR, f"{source or name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a torn file
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = res.stderr
    return out


def load_kernel_library(name, source=None, defines=()):
    """Build (if needed) and load ``lib<name>.so``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_kernel_library(name, source, defines))
            _LIBS[name] = lib
        return lib
