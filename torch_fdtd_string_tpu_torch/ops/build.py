"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``build/kernels/lib<name>.so``
under the repository root, on first use in a process, and loaded with
``ctypes``.  A library newer than its source is reused.  The sources include
no PyTorch header.  A variant of a source built with preprocessor defines (an
instrumented build) is a library of its own name.

A source of ``PARTS`` is compiled as that many translation units, all
started together, with ``-DBUILD_PART=0`` .. ``n - 1`` (string_step.cu: one
instance's kernel in each, and the dispatch in the last), and the objects
linked into the library: ptxas then compiles the instances side by side
instead of one after another.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions round them, so kernel and plain version differ only
in summation order.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]
LINK_FLAGS = ["-shared", "-Xcompiler", "-fPIC"]
# translation units per source: string_step.cu's 22 instances and its dispatch
PARTS = {"string_step": 23}

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
    source = source or name
    src = os.path.join(CSRC_DIR, f"{source}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc, defs = find_nvcc(), [f"-D{d}" for d in defines]
    t0 = time.perf_counter()
    if source in PARTS:
        log = _build_parts(nvcc, src, defs, PARTS[source], tmp)
    else:
        log = _run([nvcc, *NVCC_FLAGS, *defs, "-o", tmp, src], src)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a torn file
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = log
    return out


def _run(cmd, what):
    """Run one nvcc command; its messages, or a RuntimeError with them."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} (exit {res.returncode}):\n{res.stderr}")
    return res.stderr


def _build_parts(nvcc, src, defs, n, out):
    """Compile ``src`` as ``n`` translation units at once (``-DBUILD_PART=i``)
    and link them into ``out``; the parts' messages in part order."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"part{i}.o") for i in range(n)]
        logs = [open(os.path.join(tmp, f"part{i}.log"), "w+") for i in range(n)]
        procs = []
        try:
            for i, (obj, log) in enumerate(zip(objs, logs)):
                procs.append(subprocess.Popen(
                    [nvcc, *COMPILE_FLAGS, *defs, f"-DBUILD_PART={i}", "-c", "-o", obj, src],
                    stdout=subprocess.DEVNULL, stderr=log))
            codes = [p.wait() for p in procs]
            messages = []
            for log in logs:
                log.seek(0)
                messages.append(log.read())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        for i, code in enumerate(codes):
            if code != 0:
                raise RuntimeError(f"nvcc failed on {src} part {i} (exit {code}):\n"
                                   f"{messages[i]}")
        link = _run([nvcc, *LINK_FLAGS, "-o", out, *objs], f"{src} (link)")
    return "".join(messages) + link


def load_kernel_library(name, source=None, defines=()):
    """Build (if needed) and load ``lib<name>.so``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_kernel_library(name, source, defines))
            _LIBS[name] = lib
        return lib
