"""Fused string step: all T audio-rate steps of B independent strings.

PyTorch counterpart of ``torch_fdtd_string_tpu/ops/pallas_step.py``.  Each
step solves the implicit theta-scheme for the coupled transverse (u) and
longitudinal (z) displacement with adaptive damped block Gauss-Seidel
sweeps, each sweep two masked PCR tridiagonal solves, and reads the
output at the pickup or as the surface integral.

:func:`string_chunked` dispatches on the device of its inputs:

* CUDA tensors launch the hand-written Hopper kernel ``csrc/string_step.cu``
  (built on first use by ``ops/build.py``) or raise (the kernel has the MMS
  forcing and the fixed schedule for plucked strings only, one at a time);
* CPU tensors run :func:`string_chunked_reference`, the plain PyTorch
  version of the same algorithm, in float32 or float64.

:func:`string_chunked_bucketed` (the JAX ``string_chunked_bucketed``) runs
the strings of a batch in width groups (:func:`bucket_groups`), each at its
own block width, one launch per group on its own stream; its plain version
is :func:`string_chunked_bucketed_reference`.

Specializations: pluck, bow, hammer and any mix of them per string
(``bow`` / ``hammer`` dicts with per-string masks), the surface-integral
and the interpolated pickup readout, the manufactured-solution (MMS)
forcing of the verification runs (``manufactured=True`` with a per-string
amplitude ``p_a``), and two sweep schedules: the adaptive one
(``coupling_fixed=0``), whose untrusted exits are either poisoned
(``gmres_rescue=False``, the first pass) or solved again by the in-kernel
GMRES rescue (``gmres_rescue=True``: GMRES(16) on the step's z fixed point,
one pass, or two with an excitation), or exactly ``coupling_fixed`` plain
Gauss-Seidel sweeps with no exit test, no poison and no rescue.
:func:`string_chunked_rerun` re-runs chosen rows of a batch in place, as the
rescue ladder re-runs a first pass's NaN strings; :func:`pluck_chunked` is
the JAX package's wrapper with the older return signature.

Semantics follow the JAX kernel line by line with one deliberate change:
each string leaves its Gauss-Seidel loop, the hammer's inner fixed point
and the rescue's Arnoldi loop on its own (convergence, hopeless back-off
or NaN), where the TPU kernel iterates the whole batch block until every
string is done.  A string's result therefore never depends on the other
strings in its batch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import stencils as st
from .fdm import LN10_6
from .tridiag import pcr_normalized

OMEGA_FLOOR = 0.0625  # under-relaxation floor of the adaptive sweeps
M_HD_CLAMP = -0.01  # hammer displacement clamp (pallas_step.py:46)
HAMMER_MAX_ITER = 40  # inner hammer fixed-point cap (csrc/string_step.cu::kHammerMaxIter)
GMRES_M = 16  # the rescue's Krylov dimension (csrc/string_step.cu::kGmresM)
# the instrumented build of csrc/string_step.cu: library name, source,
# defines; and its phase classes, in the order of the source's enum Phase
CLOCKS_BUILD = ("string_step_clocks", "string_step", ("STRING_STEP_CLOCKS",))
CLOCK_PHASES = ("step_start", "rhs", "pcr_t", "stencil_tl", "pcr_l", "stencil_lt",
                "exit_reduce", "readout", "excitation", "gmres")
BOW_KEYS = ("x_b", "v_b", "F_b", "wid", "phi_0", "phi_1", "mask")
HAMMER_KEYS = ("x_H", "w_H", "M_r", "alpha", "mask")


class KernelConsts(NamedTuple):
    k: float
    theta_t: float
    lambda_c: float
    M_t: int
    M_l: int
    coupling_iters: int
    collect_state: bool
    # allocation width that sets the z live-row count (pallas_step.py:101-106)
    M_t_sem: int
    surface_integral: bool
    has_bow: bool
    has_hammer: bool
    relative_error: float  # hammer tolerance h_t ** relative_error
    # untrusted exits solved again by GMRES, not poisoned; never with a
    # fixed schedule, which has no exit test
    gmres_rescue: bool
    manufactured: bool = False  # MMS forcing (pallas_step.py:392-412)
    mms_centered: bool = False  # its time level: (n - 1) k, not n k
    coupling_fixed: int = 0  # > 0: exactly that many sweeps, no exit test

    @property
    def name(self):
        """Specialization name: pluck, bow, hammer or mix, ``-pickup`` with
        the interpolated pickup readout, ``-mms`` with the manufactured
        forcing, ``-fixed`` with the fixed sweep schedule, ``-gmres`` with
        the rescue."""
        exc = {(False, False): "pluck", (True, False): "bow",
               (False, True): "hammer", (True, True): "mix"}
        name = exc[(self.has_bow, self.has_hammer)]
        if not self.surface_integral:
            name += "-pickup"
        if self.manufactured:
            name += "-mms"
        if self.coupling_fixed > 0:
            name += "-fixed"
        return name + "-gmres" if self.gmres_rescue else name


class _LaunchArgs(ctypes.Structure):
    """csrc/string_step.cu::LaunchArgs, field for field.  The kernel checks
    ``struct_size`` against its own ``sizeof`` and refuses a mismatch."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "struct_size", "B", "T", "M_t", "M_l", "W", "M_t_sem",
            "coupling_iters", "has_bow", "has_hammer", "surface_integral",
            "gmres", "B_rows", "ld_t", "ld_l", "manufactured", "mms_centered",
            "coupling_fixed")]
        + [(n, ctypes.c_double) for n in (
            "k", "theta", "lambda_c", "relative_error")]
        + [(n, ctypes.c_void_p) for n in (
            "rows", "f0", "kappa", "alpha", "pos", "t60", "u1", "u2", "z1", "z2",
            "x_b", "v_b", "F_b", "wid", "phi_0", "phi_1", "bmask",
            "x_H", "w_H", "M_r", "alpha_H", "hmask", "uH1", "uH2", "p_a",
            "uout", "zout", "u1_out", "u2_out", "z1_out", "z2_out",
            "state_u", "state_z", "v_r", "F_H", "u_H")]
    )


def padded_width(M_t, M_l):
    """Lane width of one string: max(M_t, M_l) rounded up to whole warps.
    Lanes past a string's live grid hold identity rows and zeros."""
    return 32 * -(-max(M_t, M_l) // 32)


def pcr_levels(width):
    """PCR levels that reach across ``width`` rows: ceil(log2(width))."""
    return max(1, (width - 1).bit_length())


def _consts(*, k, theta_t, lambda_c, M_t, M_l, coupling_iters, surface_integral,
            collect_state, bow, hammer, relative_error, manufactured,
            coupling_fixed, gmres_rescue, M_t_sem, mms_centered=False):
    """Validate the requested specialization.  A fixed schedule has no
    rescue: the JAX kernel takes its rescue branch only with
    ``coupling_fixed == 0`` (pallas_step.py:177, :943)."""
    if coupling_fixed < 0:
        raise ValueError(f"coupling_fixed must be >= 0, got {coupling_fixed}")
    if coupling_iters < 1:
        raise ValueError(f"coupling_iters must be >= 1, got {coupling_iters}")
    for what, d, keys in (("bow", bow, BOW_KEYS), ("hammer", hammer, HAMMER_KEYS)):
        if d is not None and not set(keys) <= set(d):
            raise KeyError(f"{what} needs {sorted(keys)}, got {sorted(d)}")
    return KernelConsts(
        k=float(k), theta_t=float(theta_t), lambda_c=float(lambda_c),
        M_t=int(M_t), M_l=int(M_l), coupling_iters=int(coupling_iters),
        collect_state=bool(collect_state),
        M_t_sem=int(M_t if M_t_sem is None else M_t_sem),
        surface_integral=bool(surface_integral),
        has_bow=bow is not None, has_hammer=hammer is not None,
        relative_error=float(relative_error),
        gmres_rescue=bool(gmres_rescue) and coupling_fixed == 0,
        manufactured=bool(manufactured), mms_centered=bool(mms_centered),
        coupling_fixed=int(coupling_fixed),
    )


def _excitation(f0, bow, hammer, p_a=None):
    """The excitation inputs as one dict in ``f0``'s dtype: bow signals
    ``(B, T)``, per-string scalars ``(B, 1)``, masks as 0/1 values and the
    initial hammer displacements ``uH1``/``uH2`` (``(B, 1)``; -1e-3 when
    absent, as the JAX kernel defaults them); with ``p_a``, the MMS
    amplitude ``(B, 1)``."""
    B = f0.shape[0]
    as_dt = lambda x: torch.as_tensor(x, device=f0.device).to(f0.dtype)
    exc = {}
    if bow is not None:
        for key in ("x_b", "v_b", "F_b", "wid"):
            exc[key] = as_dt(bow[key])
        for key in ("phi_0", "phi_1"):
            exc[key] = as_dt(bow[key]).reshape(B, 1)
        exc["bmask"] = as_dt(bow["mask"]).reshape(B, 1)
    if hammer is not None:
        for key in ("x_H", "w_H", "M_r"):
            exc[key] = as_dt(hammer[key]).reshape(B, 1)
        exc["alpha_H"] = as_dt(hammer["alpha"]).reshape(B, 1)
        exc["hmask"] = as_dt(hammer["mask"]).reshape(B, 1)
    if exc:
        src = hammer if hammer is not None else bow
        for key in ("uH1", "uH2"):
            x = src.get(key)
            exc[key] = (torch.full((B, 1), -1e-3, dtype=f0.dtype, device=f0.device)
                        if x is None else as_dt(x).reshape(B, 1))
    if p_a is not None:
        exc["p_a"] = as_dt(p_a).reshape(B, 1)
    return exc


def _mms_amplitude(c, p_a):
    """``p_a`` when the MMS forcing is on (it must be given then), else
    None: the forcing's amplitude is an input only of that
    specialization."""
    if not c.manufactured:
        return None
    if p_a is None:
        raise ValueError("MMS forcing (manufactured=True) needs the p_a amplitude")
    return p_a


def string_chunked(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *,
                   k, theta_t, lambda_c, M_t, M_l, chunk=512,
                   coupling_iters=24, surface_integral=False, interpret=False,
                   batch_block=64, collect_state=False,
                   bow=None, hammer=None, relative_error=4.0,
                   manufactured=False, mms_centered=False, p_a=None,
                   coupling_fixed=0, gmres_rescue=True, gmres_m=16,
                   M_t_sem=None):
    """Run the fused string step over a full ``(B, T)`` f0 control signal.

    Arguments and results match the JAX ``string_chunked``:
    ``f0 (B, T)``, ``kappa/alpha/pos (B,)``, ``t60 (B, 2, 2)``,
    ``u1/u2 (B, M_t)``, ``z1/z2 (B, M_l)``; ``bow`` holds ``x_b/v_b/F_b/wid
    (B, T)`` and ``phi_0/phi_1/mask (B,)``, ``hammer`` holds
    ``x_H/w_H/M_r/alpha/mask (B,)``, and either may hold the initial hammer
    displacements ``uH1/uH2 (B,)``.  Returns ``(uout (B, T), zout (B, T),
    aux)``; ``aux["carry"]`` is the final ``(u1, u2, z1, z2)``; with an
    excitation ``aux["v_r"]``, ``aux["F_H"]`` and ``aux["u_H"]`` are the
    ``(B, T)`` probe traces; with ``collect_state``, ``aux["state_u"]
    (T, B, M_t)`` and ``aux["state_z"] (T, B, M_l)`` hold every step's
    state.

    ``chunk``, ``batch_block`` and ``interpret`` are the TPU kernel's
    tiling and have no effect here: the CUDA kernel loops over all T steps
    inside one block per string.  With ``manufactured``, ``p_a (B,)`` is
    the MMS amplitude and the forcing's time is ``(n - [mms_centered]) k``,
    ``n`` counting the launch's first step as step 2, as the JAX kernel
    counts it.  ``gmres_m`` is accepted for the JAX signature's sake; the
    rescue's Krylov dimension is ``GMRES_M``, as in every call the JAX
    package makes.
    """
    c = _consts(
        k=k, theta_t=theta_t, lambda_c=lambda_c, M_t=M_t, M_l=M_l,
        coupling_iters=coupling_iters, surface_integral=surface_integral,
        collect_state=collect_state, bow=bow, hammer=hammer,
        relative_error=relative_error, manufactured=manufactured,
        mms_centered=mms_centered, coupling_fixed=coupling_fixed,
        gmres_rescue=gmres_rescue, M_t_sem=M_t_sem,
    )
    args = (f0, kappa, alpha, pos, t60, u1, u2, z1, z2)
    p_a = _mms_amplitude(c, p_a)
    if f0.is_cuda:
        return _launch_cuda(c, *args, bow, hammer, p_a)
    if f0.device.type == "cpu":
        return _reference(c, *args, _excitation(f0, bow, hammer, p_a))
    raise ValueError(f"string_chunked: unsupported device {f0.device}")


# kernel launches per specialization (KernelConsts.name); the CPU path does
# not count
string_chunked.launches_by_spec = {}


def reset_launch_counts():
    string_chunked.launches_by_spec = {}
    string_chunked_bucketed.launches = 0


def pluck_chunked(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, **kw):
    """:func:`string_chunked` with the JAX ``pluck_chunked`` return
    signature (pallas_step.py:1208-1217): ``(uout, zout, fin)``, ``fin``
    the final carry ``(u1, u2, z1, z2)`` followed, with ``collect_state``,
    by ``state_u`` and ``state_z``.  The keyword defaults are
    ``string_chunked``'s, ``gmres_rescue=True`` among them: on the card it
    launches the GMRES instance, counted under its name in
    ``string_chunked.launches_by_spec``."""
    uout, zout, aux = string_chunked(f0, kappa, alpha, pos, t60, u1, u2, z1, z2,
                                     **kw)
    fin = aux["carry"]
    if kw.get("collect_state", False):
        fin = fin + (aux["state_u"], aux["state_z"])
    return uout, zout, fin


def string_chunked_clocks(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *, M_t, M_l,
                          bucketed=False, host_bounds=None, **kw):
    """:func:`string_chunked` (with ``bucketed``,
    :func:`string_chunked_bucketed`) through the instrumented build of the
    kernel (``CLOCKS_BUILD``): returns its results and a ``(B,
    len(CLOCK_PHASES) + 1)`` int64 tensor, each string's clock64() cycles
    per phase class (thread 0 of its CTA) summed over the steps, and in the
    last column its Gauss-Seidel sweeps.  CUDA tensors only; the main path
    never loads this build."""
    if not f0.is_cuda:
        raise ValueError("string_chunked_clocks: the instrumented kernel needs CUDA "
                         f"tensors, got {f0.device}")
    c, groups, exc = _bucketing(f0, kappa, alpha, M_t, M_l, host_bounds, kw)
    if not bucketed:
        groups = None
    clocks = torch.zeros((f0.shape[0], len(CLOCK_PHASES) + 1), dtype=torch.int64,
                         device=f0.device)
    out = _launch_cuda(c, f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *exc,
                       groups=groups, clocks=clocks)
    return out, clocks


def string_chunked_reference(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *,
                             k, theta_t, lambda_c, M_t, M_l, chunk=512,
                             coupling_iters=24, surface_integral=False,
                             interpret=False, batch_block=64,
                             collect_state=False, bow=None, hammer=None,
                             relative_error=4.0, manufactured=False,
                             mms_centered=False, p_a=None, coupling_fixed=0,
                             gmres_rescue=True, gmres_m=16, M_t_sem=None):
    """Plain PyTorch version of :func:`string_chunked` on any device.

    Same arguments, results and specializations.  Batched tensor ops in the
    inputs' dtype (float32 or float64), one Python iteration per step and
    per sweep.  ``aux["sweeps"]`` (T, B) int32 also counts each string's
    Gauss-Seidel sweeps per step, and with ``gmres_rescue``
    ``aux["gmres_iters"]`` (T, B) its Arnoldi iterations, the work the
    kernel does on the same data.
    """
    c = _consts(
        k=k, theta_t=theta_t, lambda_c=lambda_c, M_t=M_t, M_l=M_l,
        coupling_iters=coupling_iters, surface_integral=surface_integral,
        collect_state=collect_state, bow=bow, hammer=hammer,
        relative_error=relative_error, manufactured=manufactured,
        mms_centered=mms_centered, coupling_fixed=coupling_fixed,
        gmres_rescue=gmres_rescue, M_t_sem=M_t_sem,
    )
    return _reference(c, f0, kappa, alpha, pos, t60, u1, u2, z1, z2,
                      _excitation(f0, bow, hammer, _mms_amplitude(c, p_a)))


# smallest width group: a smaller one merges into the next wider group
# (pallas_step.py:1032 with the fused path's batch_block=8)
G_MIN = 16


def grid_bounds(f0_min, kappa, alpha, k, theta_t, lambda_c):
    """Per-string upper bounds on the live grid sizes, ``(bt, bl)`` int64.

    Twin of the JAX ``_grid_bounds``: float64, a 1e-6 inflation before the
    floor, so the bound dominates the kernel's per-step f32 arithmetic (a
    few-ULP sqrt skew); ``f0_min`` is each string's minimum over its whole
    control signal, since the grids grow as f0 falls.
    """
    f0 = np.asarray(f0_min, np.float64)
    kap = np.asarray(kappa, np.float64)
    alp = np.asarray(alpha, np.float64)
    gamma = 2.0 * f0
    K = kap * gamma
    two_t = 2.0 * theta_t - 1.0
    h_1 = lambda_c * np.sqrt(
        (gamma**2 * k**2 + np.sqrt(gamma**4 * k**4 + 16.0 * K**2 * k**2 * two_t))
        / (2.0 * two_t)
    )
    n_t = np.floor((1.0 / h_1) * (1.0 + 1e-6))
    h_2 = lambda_c * gamma * alp * k
    n_l = np.floor((1.0 / h_2) * (1.0 + 1e-6))
    return (n_t + 2.0).astype(np.int64), (n_l + 2.0).astype(np.int64)


def bucket_groups(f0, kappa, alpha, *, k, theta_t, lambda_c, M_t, M_l):
    """Width groups of a batch: a list of ``(W_g, rows)``, ``rows`` an int64
    index array, every string in exactly one group.

    Each string needs ``32 ceil(max(bt, bl) / 32)`` lanes (the warp is the
    width quantum), at most the allocation's :func:`padded_width`.  Strings
    are sorted by need and grouped contiguously; a group smaller than
    ``G_MIN`` merges upward into the next wider one.  A batch smaller than
    ``2 G_MIN`` runs as one group at its widest need.  ``f0`` is ``(B, T)``
    or ``(B,)`` and ``kappa``/``alpha`` ``(B,)``, host arrays (f32 as the
    sampler made them).
    """
    f0_min, kap, alp = (np.asarray(a, np.float32).reshape(len(a), -1).min(axis=1)
                        for a in (f0, kappa, alpha))
    bt, bl = grid_bounds(f0_min, kap, alp, k, theta_t, lambda_c)
    need = np.minimum(32 * ((np.maximum(bt, bl) + 31) // 32),
                      padded_width(M_t, M_l)).astype(np.int64)
    B = len(need)
    if B < 2 * G_MIN:
        return [(int(need.max()), np.arange(B))]
    order = np.argsort(need, kind="stable")
    need_s = need[order]
    groups, start = [], 0
    for width in sorted(set(need_s.tolist())):
        end = int(np.searchsorted(need_s, width, side="right"))
        if end - start < G_MIN and end < B:
            continue  # merges into the next wider group
        groups.append((int(width), order[start:end]))
        start = end
    return groups


def shard_groups(groups, rows):
    """The groups of :func:`bucket_groups` of a whole batch, cut to the
    contiguous ``rows`` (a slice) and renumbered from 0: a rank's launch
    groups at the whole batch's widths."""
    out = []
    for width, g in groups:
        g = np.asarray(g, np.int64)
        g = g[(g >= rows.start) & (g < rows.stop)] - rows.start
        if len(g):
            out.append((width, np.sort(g)))
    return out


def string_chunked_bucketed(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *,
                            M_t, M_l, host_bounds=None, groups=None, **kw):
    """Width-bucketed :func:`string_chunked`: same arguments and results.

    The strings of a batch live on grids of very different sizes (they
    scale ~1/f0) while the allocation is sized for the lowest f0 the
    sampler can draw.  This runs each group of :func:`bucket_groups` at its
    own block width, lanes ``min(M_t, W_g)`` / ``min(M_l, W_g)``, with the
    allocation's ``M_t`` as ``M_t_sem``; lanes of the carry and state past
    a group's width are 0.  Results equal the unbucketed call's up to the
    order of the block reductions.

    ``host_bounds`` is ``(f0, kappa, alpha)`` as host arrays, the sampler's
    copies; without it they are copied from the inputs.  ``groups`` gives
    the ``(W_g, rows)`` groups instead (a rank's rows of a sharded batch,
    grouped at the widths of the whole batch's :func:`bucket_groups`, so
    that every string runs as in the single-card launch).  CUDA tensors
    launch one kernel per group, each on its own stream, joined to the
    current stream before return; CPU tensors run
    :func:`string_chunked_bucketed_reference`.
    """
    c, groups, exc = _bucketing(f0, kappa, alpha, M_t, M_l, host_bounds, kw, groups)
    args = (f0, kappa, alpha, pos, t60, u1, u2, z1, z2)
    if f0.is_cuda:
        out = _launch_cuda(c, *args, *exc, groups=groups)
        string_chunked_bucketed.launches += len(groups)
        return out
    if f0.device.type == "cpu":
        return _bucketed_reference(c, groups, *args, *exc)
    raise ValueError(f"string_chunked_bucketed: unsupported device {f0.device}")


# group launches of string_chunked_bucketed; the CPU path does not count
string_chunked_bucketed.launches = 0


def string_chunked_bucketed_reference(f0, kappa, alpha, pos, t60, u1, u2, z1,
                                      z2, *, M_t, M_l, host_bounds=None, groups=None,
                                      **kw):
    """Plain PyTorch version of :func:`string_chunked_bucketed` on any
    device: :func:`_reference` per group at the group's width, scattered
    back into the batch."""
    c, groups, exc = _bucketing(f0, kappa, alpha, M_t, M_l, host_bounds, kw, groups)
    return _bucketed_reference(c, groups, f0, kappa, alpha, pos, t60, u1, u2,
                               z1, z2, *exc)


def string_chunked_rerun(f0, kappa, alpha, pos, t60, u1, u2, z1, z2, *, rows,
                         out, M_t, M_l, host_bounds=None, groups=None, **kw):
    """Re-run the strings ``rows`` of a batch, writing their results in
    place into ``out``: the ``(uout, zout, aux)`` of an earlier
    :func:`string_chunked_bucketed` call on the same inputs (the rescue
    ladder re-runs a first pass's NaN rows with ``gmres_rescue=True``).

    Each string runs at its width group's width in the whole batch's
    :func:`bucket_groups`, one launch per group that holds a row of
    ``rows``, so its result equals a whole-batch call with the same
    keywords bit for bit, and the other rows keep ``out``'s values
    (``groups``: the batch's groups as :func:`string_chunked_bucketed`
    takes them).  With
    ``gmres_rescue``, ``aux["gmres_iters"]`` is added on the CPU.  Returns
    ``out``.
    """
    c, groups, exc = _rerun_groups(f0, kappa, alpha, rows, M_t, M_l, host_bounds, kw,
                                   groups)
    args = (f0, kappa, alpha, pos, t60, u1, u2, z1, z2)
    if not groups:
        return out
    if f0.is_cuda:
        return _launch_cuda(c, *args, *exc, groups=groups, out=out)
    if f0.device.type == "cpu":
        return _bucketed_reference(c, groups, *args, *exc, out=out)
    raise ValueError(f"string_chunked_rerun: unsupported device {f0.device}")


def string_chunked_rerun_reference(f0, kappa, alpha, pos, t60, u1, u2, z1, z2,
                                   *, rows, out, M_t, M_l, host_bounds=None, groups=None,
                                   **kw):
    """Plain PyTorch version of :func:`string_chunked_rerun` on any device:
    :func:`_reference` per group that holds a row of ``rows``, at the
    group's width, written in place into ``out``."""
    c, groups, exc = _rerun_groups(f0, kappa, alpha, rows, M_t, M_l, host_bounds, kw,
                                   groups)
    if not groups:
        return out
    return _bucketed_reference(c, groups, f0, kappa, alpha, pos, t60, u1, u2, z1,
                               z2, *exc, out=out)


def _rerun_groups(f0, kappa, alpha, rows, M_t, M_l, host_bounds, kw, groups=None):
    """:func:`_bucketing` of a re-run: the whole batch's groups, each cut to
    its rows in ``rows``, the empty ones dropped."""
    c, groups, exc = _bucketing(f0, kappa, alpha, M_t, M_l, host_bounds, kw, groups)
    rows = np.asarray(rows, np.int64)
    groups = [(w, np.intersect1d(g, rows)) for w, g in groups]
    return c, [(w, g) for w, g in groups if len(g)], exc


def _bucketing(f0, kappa, alpha, M_t, M_l, host_bounds, kw, groups=None):
    """The validated constants, the width groups of a bucketed call (the
    given ``groups``, else :func:`bucket_groups`) and its ``(bow, hammer,
    p_a)`` inputs."""
    c = _consts(M_t=M_t, M_l=M_l, M_t_sem=None, **_kernel_kw(kw))
    if groups is not None:
        rows = np.sort(np.concatenate([np.asarray(g, np.int64) for _, g in groups]))
        if not np.array_equal(rows, np.arange(f0.shape[0])):
            raise ValueError("groups must hold every row of the batch exactly once")
        widest = padded_width(M_t, M_l)
        if any(not 0 < w <= widest for w, _ in groups):
            raise ValueError(f"a group's width outside 1..{widest}")
    else:
        if host_bounds is None:
            host_bounds = (f0.amin(dim=1).cpu().numpy(), kappa.cpu().numpy(),
                           alpha.cpu().numpy())
        groups = bucket_groups(*host_bounds, k=c.k, theta_t=c.theta_t,
                               lambda_c=c.lambda_c, M_t=M_t, M_l=M_l)
    return c, groups, (kw.get("bow"), kw.get("hammer"), _mms_amplitude(c, kw.get("p_a")))


def _kernel_kw(kw):
    """:func:`_consts` arguments from the keyword arguments of a call."""
    if kw.get("M_t_sem") is not None:
        raise ValueError("the bucketed launch sets M_t_sem itself")
    defaults = dict(coupling_iters=24, surface_integral=False,
                    collect_state=False, bow=None, hammer=None,
                    relative_error=4.0, manufactured=False, mms_centered=False,
                    coupling_fixed=0, gmres_rescue=True)
    tiling = {"chunk", "interpret", "batch_block", "p_a", "gmres_m", "M_t_sem"}
    unknown = set(kw) - set(defaults) - tiling - {"k", "theta_t", "lambda_c"}
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    out = {key: kw.get(key, val) for key, val in defaults.items()}
    for key in ("k", "theta_t", "lambda_c"):
        out[key] = kw[key]
    return out


@torch.inference_mode()
def _bucketed_reference(c, groups, f0, kappa, alpha, pos, t60, u1, u2, z1, z2,
                        bow, hammer, p_a, out=None):
    """:func:`_reference` per group, scattered into the batch's arrays:
    new ones, or those of ``out`` (``(uout, zout, aux)``) in place."""
    B, T = f0.shape
    dt, dev = f0.dtype, f0.device
    exc = _excitation(f0, bow, hammer, p_a)
    full = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    counts = lambda: torch.zeros((T, B), dtype=torch.int32, device=dev)
    if out is None:
        uout, zout = full(B, T), full(B, T)
        carry = [full(B, c.M_t), full(B, c.M_t), full(B, c.M_l), full(B, c.M_l)]
        aux = {"sweeps": counts()}
        if c.has_bow or c.has_hammer:
            aux.update({key: full(B, T) for key in ("v_r", "F_H", "u_H")})
        if c.collect_state:
            aux["state_u"], aux["state_z"] = full(T, B, c.M_t), full(T, B, c.M_l)
    else:
        uout, zout, aux = out
        carry = list(aux["carry"])
    if c.gmres_rescue and "gmres_iters" not in aux:
        aux["gmres_iters"] = counts()
    for W_g, rows in groups:
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        M_t_g, M_l_g = min(c.M_t, W_g), min(c.M_l, W_g)
        c_g = c._replace(M_t=M_t_g, M_l=M_l_g)  # M_t_sem stays the allocation's
        uo, zo, aux_g = _reference(
            c_g, f0[idx], kappa[idx], alpha[idx], pos[idx], t60[idx],
            u1[idx, :M_t_g], u2[idx, :M_t_g], z1[idx, :M_l_g], z2[idx, :M_l_g],
            {key: v[idx] for key, v in exc.items()})
        uout[idx], zout[idx] = uo, zo
        for key in ("sweeps", "gmres_iters"):
            if key in aux:
                aux[key][:, idx] = aux_g[key]
        for full_c, part in zip(carry, aux_g["carry"]):
            full_c[idx, : part.shape[1]] = part
        for key in ("v_r", "F_H", "u_H"):
            if key in aux:
                aux[key][idx] = aux_g[key]
        if c.collect_state:
            aux["state_u"][:, idx, :M_t_g] = aux_g["state_u"]
            aux["state_z"][:, idx, :M_l_g] = aux_g["state_z"]
    aux["carry"] = tuple(carry)
    return uout, zout, aux


def _sign(x):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


@torch.inference_mode()
def _reference(c: KernelConsts, f0, kappa, alpha, pos, t60, u1, u2, z1, z2, exc):
    B, T = f0.shape
    dt, dev = f0.dtype, f0.device
    W = padded_width(c.M_t, c.M_l)
    levels = pcr_levels(W)
    k, theta, lambda_c = c.k, c.theta_t, c.lambda_c
    inner_eps = 100.0 * float(torch.finfo(dt).eps)
    two_t = 2.0 * theta - 1.0
    has_exc = c.has_bow or c.has_hammer
    p_a = exc.get("p_a")

    def pad(x, M):
        return torch.nn.functional.pad(x, (0, W - M))

    u1s, u2s = pad(u1, c.M_t), pad(u2, c.M_t)
    z1s, z2s = pad(z1, c.M_l), pad(z2, c.M_l)
    kappa = kappa[:, None]
    alpha = alpha[:, None]
    pos = pos[:, None]
    t60f = t60.reshape(B, 4)
    freq1, time1, freq2, time2 = (t60f[:, j : j + 1] for j in range(4))
    it = torch.arange(W, device=dev)[None, :]
    itf = it.to(dt)
    one = torch.ones((B, 1), dtype=dt, device=dev)
    zero = torch.zeros((B, 1), dtype=dt, device=dev)

    uout = torch.empty((B, T), dtype=dt, device=dev)
    zout = torch.empty((B, T), dtype=dt, device=dev)
    sweeps = torch.zeros((T, B), dtype=torch.int32, device=dev)
    gmres_iters = torch.zeros((T, B), dtype=torch.int32, device=dev)
    if c.collect_state:
        state_u = torch.empty((T, B, c.M_t), dtype=dt, device=dev)
        state_z = torch.empty((T, B, c.M_l), dtype=dt, device=dev)
    if has_exc:
        traces = {key: torch.empty((B, T), dtype=dt, device=dev)
                  for key in ("v_r", "F_H", "u_H")}
        uH1, uH2 = exc["uH1"], exc["uH2"]  # the uHs carry (pallas_step.py:176)
    if c.has_bow:  # spatial axis of the allocation (M_t_sem), not the bucket
        bmask, phi0, phi1 = exc["bmask"], exc["phi_0"], exc["phi_1"]
        xax = (itf + 1.0) / c.M_t_sem
        in_mt = (it < c.M_t_sem).to(dt)
    if c.has_hammer:
        hmask = exc["hmask"]
        a_H = exc["alpha_H"]
        w_H = exc["w_H"] / lambda_c
        M_r = exc["M_r"] / lambda_c

    def interp_idx(n_in, n_out):
        denom = torch.clamp(n_out - 1.0, min=1.0)
        posn = torch.minimum(torch.clamp(itf * (n_in - 1.0) / denom, min=0.0),
                             n_in - 1.0)
        lo = torch.floor(posn)
        frac = posn - lo
        lo_i = torch.clamp(lo.long(), 0, W - 1)
        hi_i = torch.minimum(lo_i + 1, torch.clamp(n_in.long() - 1, min=0))
        return lo_i, hi_i, frac, (itf < n_out).to(dt)

    def interp(src, d):
        lo_i, hi_i, frac, mask = d
        return (torch.gather(src, 1, lo_i) * (1.0 - frac)
                + torch.gather(src, 1, hi_i) * frac) * mask

    for t in range(T):
        # ---- per-step grid and loss terms (pallas_step.py:248-291) --------
        gamma = 2.0 * f0[:, t : t + 1]
        K = kappa * gamma
        g2 = gamma * gamma
        g4 = g2 * g2
        KK = K * K
        h_1 = lambda_c * torch.sqrt(
            (g2 * k**2 + torch.sqrt(g4 * k**4 + 16.0 * KK * k**2 * two_t))
            / (2.0 * two_t))
        N_t = torch.floor(1.0 / h_1)
        h_t = 1.0 / N_t
        h_2 = lambda_c * gamma * alpha * k
        N_l = torch.floor(1.0 / h_2)
        h_l = 1.0 / N_l
        n_t = N_t + 1.0
        n_l = N_l + 1.0

        gg = torch.where(gamma != 0.0, gamma, one)
        g2s = gg * gg

        def zeta(freq):
            x = 2 * math.pi * freq
            return torch.where(K > 0, -g2 + torch.sqrt(g4 + 4 * KK * (x * x)),
                               freq * freq / g2s)

        zeta1, zeta2 = zeta(freq1), zeta(freq2)
        lossy = (freq1 * time1 * freq2 * time2) != 0.0
        st1 = torch.where(time1 != 0.0, time1, one)
        st2 = torch.where(time2 != 0.0, time2, one)
        lossy_f = lossy.to(dt)
        sig0 = torch.where(lossy, -zeta2 / st1 + zeta1 / st2, lossy_f)
        sig1 = torch.where(lossy, 1.0 / st1 - 1.0 / st2, lossy_f)
        scale = LN10_6 / (zeta1 - zeta2)
        sig0 = scale * sig0
        sig1 = scale * sig1

        live_t = (itf < n_t).to(dt)
        live_l = (itf < n_l).to(dt)
        u1 = st.mask_live(u1s, n_t[:, 0])
        u2 = st.mask_live(u2s, n_t[:, 0])
        z1 = st.mask_live(z1s, n_l[:, 0])
        z2 = st.mask_live(z2s, n_l[:, 0])

        gamma_k = g2 * k**2
        phi_pow = gamma_k * (alpha * alpha - 1.0) / 4.0
        lam = st.dxb(u1, h_t)
        lam2 = lam * lam
        lt = interp_idx(n_l, n_t)  # z (l-grid) -> t-grid
        tl = interp_idx(n_t, n_l)  # u-derived (t-grid) -> l-grid
        hh_t = h_t * h_t
        hh_l = h_l * h_l

        def dxxxx_cl(x):
            pent = (st.shift(x, -2) - 4.0 * st.shift(x, -1) + 6.0 * x
                    - 4.0 * st.shift(x, 1) + st.shift(x, 2))
            corr = torch.where((it == 1) | (itf == (n_t - 2.0)), x,
                               torch.zeros_like(x))
            return (pent + corr) / (hh_t * hh_t)

        def K_tl_from(w):
            return -phi_pow * st.dxf(lam * st.dxb(w, h_t), h_t)

        def K_lt_from(w):
            return -phi_pow * st.dxf(w, h_l)

        # ---- LHS tridiagonals (pallas_step.py:360-374) ---------------------
        a_t = (1.0 - theta) / 2.0 - 2.0 * sig1 * k / hh_t
        b_t = theta + 2.0 * sig0 * k + 4.0 * sig1 * k / hh_t
        d_next = st.shift(lam2, -1)
        zeros = torch.zeros_like(lam2)
        sub_t = torch.where((it >= 1) & (itf < n_t),
                            a_t - phi_pow * lam2 / hh_t, zeros)
        diag_t = torch.where(itf < n_t,
                             b_t + phi_pow * (lam2 + d_next) / hh_t,
                             torch.ones_like(lam2))
        sup_t = torch.where(itf < (n_t - 1.0),
                            a_t - phi_pow * d_next / hh_t, zeros)
        a_l = -2.0 * sig1 * k / hh_l
        b_l = 1.0 + 2.0 * sig0 * k + 4.0 * sig1 * k / hh_l
        sub_l = torch.where((it >= 1) & (itf < n_l), a_l, zeros)
        diag_l = torch.where(itf < n_l, b_l, torch.ones_like(lam2))
        sup_l = torch.where(itf < (n_l - 1.0), a_l, zeros)

        # ---- RHS B w1 + C w2 (pallas_step.py:376-415) ----------------------
        iz1 = interp(z1, lt)
        iz2 = interp(z2, lt)
        iu2 = interp(lam * st.dxb(u2, h_t), tl)
        V_u2 = -phi_pow * (
            lam2 * st.shift(u2, 1) - (lam2 + d_next) * u2
            + d_next * st.shift(u2, -1)) / hh_t
        B1u1 = (-2.0 * st.theta_op(u1, theta) - gamma_k * st.dxx(u1, h_t)
                + KK * k**2 * dxxxx_cl(u1))
        C1u2 = (st.theta_op(u2, theta) - 2.0 * sig0 * k * u2
                + 2.0 * sig1 * k * st.dxx(u2, h_t) + V_u2)
        K_tl1 = K_tl_from(iz1)
        rhs_u0 = B1u1 + C1u2 + 2.0 * K_tl1 + K_tl_from(iz2)
        B4z1 = -2.0 * z1 - gamma_k * (alpha * alpha) * st.dxx(z1, h_l)
        C4z2 = (1.0 - 2.0 * sig0 * k) * z2 + 2.0 * sig1 * k * st.dxx(z2, h_l)
        rhs_z = B4z1 + C4z2 + K_lt_from(iu2)
        if c.manufactured:
            # manufactured-solution forcing (pallas_step.py:392-412, engine
            # ``mms_forcing``): sigma == sig0, omega == gamma, mu == pi; u at
            # its grid's x in [-1/2, 1/2], z at the constant x = 1/2
            t_now = (t + 2 - (1 if c.mms_centered else 0)) * torch.ones(
                (), dtype=dt, device=dev) * k

            def mms(x):
                c1 = (sig0 * sig0 - gamma * gamma - 2.0 * sig0 * sig0) * torch.cos(
                    math.pi * x) ** 2
                c2 = (2.0 * math.pi**2 * (4.0 * KK * math.pi**2 + gamma * gamma)
                      * torch.cos(2.0 * math.pi * x))
                return (p_a * (c1 + c2) * torch.cos(gamma * t_now)
                        * torch.exp(-sig0 * t_now))

            x_u = (torch.clamp(2.0 * itf / N_t, 0.0, 2.0) - 1.0) / 2.0
            rhs_u0 = rhs_u0 - mms(x_u) * k**2
            rhs_z = rhs_z - mms(torch.full_like(itf, 0.5)) * k**2
        z_keep = torch.minimum(
            torch.clamp(N_t + N_l + 2.0 - c.M_t_sem, min=0.0), n_l)
        rhs_z = rhs_z * (itf < z_keep).to(dt)

        # ---- excitation profiles, iterate-independent parts
        # (pallas_step.py:418-447) -------------------------------------------
        if c.has_bow:
            x_b, v_b, F_b = (exc[key][:, t : t + 1] for key in ("x_b", "v_b", "F_b"))
            wid_b = exc["wid"][:, t : t + 1] * h_t
            nmin1 = N_t - 1.0
            ctr = x_b * nmin1 / c.M_t_sem
            wd = wid_b * nmin1 / c.M_t_sem
            ind = _sign(torch.clamp(
                -(xax - ctr - wd / 2.0) * (xax - ctr + wd / 2.0), min=0.0))
            rc = 0.5 * ind * (1.0 + torch.cos(2.0 * math.pi * (xax - ctr) / wd))
            rc = rc * in_mt
            rc = rc / torch.sum(torch.abs(rc), dim=1, keepdim=True)
        if c.has_hammer:
            tol_t = h_t ** c.relative_error
            eps_prof = (itf == torch.floor(exc["x_H"] * (N_t - 1.0))).to(dt)
            eta_1 = uH1 - torch.sum(eps_prof * u1, dim=1, keepdim=True)
            eta_2 = uH2 - torch.sum(eps_prof * u2, dim=1, keepdim=True)
            # iteration-invariant factor of the power-law force
            f_pow = (torch.pow(w_H, 1.0 + a_H)
                     * torch.pow(torch.clamp(eta_1, min=0.0), a_H - 1.0))

        def exc_rhs(u_c, first):
            """``rhs_u`` with the excitation terms linearized at ``u_c``, and
            the probe values (pallas_step.py:452-503)."""
            rhs = rhs_u0
            v_rel = F_H = u_H = zero
            if c.has_bow:
                du = (u1 - u2) if first else (u_c - u1)
                v_rel = torch.sum(rc * (du / k - v_b), dim=1, keepdim=True)
                phi = _sign(v_rel) * (phi1 + (1.0 - phi1) * torch.exp(-phi0 * torch.abs(v_rel)))
                G_B = -(k**2) * (rc / h_t) * (F_b * phi)
                rhs = rhs + bmask * torch.nan_to_num(G_B)
            if c.has_hammer:
                eps_u = torch.sum(eps_prof * u_c, dim=1, keepdim=True)
                F_H, u_H = _hammer_fixed_point(
                    uH1, uH2, eta_1 * hmask, eta_1, eta_2, f_pow, eps_u, hmask,
                    tol_t, k)
                G_H = -(k**2) * eps_prof * (M_r * F_H)
                rhs = rhs + hmask * torch.nan_to_num(G_H)
            return rhs * live_t, v_rel, F_H, u_H

        def lin_sweep_z(z_c, rhs_u_s, rhs_z_s):
            """One Gauss-Seidel sweep from ``z_c`` (pallas_step.py:617-622)."""
            u_g = pcr_normalized(sub_t, diag_t, sup_t,
                                 -rhs_u_s - K_tl_from(interp(z_c, lt)), levels)
            iu = interp(lam * st.dxb(u_g, h_t), tl)
            return u_g, pcr_normalized(sub_l, diag_l, sup_l,
                                       -rhs_z_s - K_lt_from(iu), levels)

        def rescue(live):
            """GMRES(m) on the z fixed point (I - G) z = c, G one RHS-free
            sweep, for the strings ``live`` (pallas_step.py:732-758): one
            pass, or two with an excitation, its RHS linearized at the first
            pass's u.  Returns u (NaN where the Krylov residual stays above
            1e-3), z, the probe values and each string's Arnoldi count."""
            zmat = torch.zeros_like(z1)
            u_lin = u1
            iters = torch.zeros(B, dtype=torch.int32, device=dev)
            for p in range(2 if has_exc else 1):
                if has_exc:
                    rhs_p, *probes = exc_rhs(u_lin, p == 0)
                else:
                    rhs_p, probes = rhs_u0 * live_t, (zero, zero, zero)
                _, cvec = lin_sweep_z(zmat, rhs_p, rhs_z)
                z_sol, relres, n_it = _gmres_fp(
                    lambda v: v - lin_sweep_z(v, zmat, zmat)[1], cvec, live,
                    GMRES_M)
                iters += n_it
                u_lin = pcr_normalized(sub_t, diag_t, sup_t,
                                       -rhs_p - K_tl_from(interp(z_sol, lt)), levels)
            u_fix = torch.where(relres <= 1e-3, u_lin, torch.full_like(u_lin, math.nan))
            return u_fix, z_sol, probes, iters

        # ---- adaptive damped block Gauss-Seidel (pallas_step.py:505-578),
        # each string frozen once it has exited; or exactly coupling_fixed
        # plain sweeps (:517-519, :562-570)
        u_c, z_c = u1, z1
        omega = torch.ones((B, 1), dtype=dt, device=dev)
        prev = torch.full((B, 1), math.inf, dtype=dt, device=dev)
        hopeless = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        scale_u = zero
        active = torch.ones((B, 1), dtype=torch.bool, device=dev)
        K_tl = K_tl1  # sweep 1 reuses the RHS pass's z interpolation
        if has_exc:
            v_rel = F_H = u_H = zero
        else:
            rhs_u = rhs_u0 * live_t  # iterate-independent: built once
        for sweep in range(c.coupling_fixed or c.coupling_iters):
            if has_exc:
                rhs_u, v_rel_s, F_H_s, u_H_s = exc_rhs(u_c, sweep == 0)
                v_rel = torch.where(active, v_rel_s, v_rel)
                F_H = torch.where(active, F_H_s, F_H)
                u_H = torch.where(active, u_H_s, u_H)
            if sweep > 0:
                K_tl = K_tl_from(interp(z_c, lt))
            u_g = pcr_normalized(sub_t, diag_t, sup_t, -rhs_u - K_tl, levels)
            iu = interp(lam * st.dxb(u_g, h_t), tl)
            z_g = pcr_normalized(sub_l, diag_l, sup_l, -rhs_z - K_lt_from(iu),
                                 levels)
            sweeps[t] += active[:, 0]
            if c.coupling_fixed:
                u_c, z_c = u_g, z_g
                continue
            u_c2 = u_c + omega * (u_g - u_c)
            z_c2 = z_c + omega * (z_g - z_c)
            delta = (torch.amax(torch.abs(u_g - u_c), dim=1, keepdim=True)
                     + torch.amax(torch.abs(z_g - z_c), dim=1, keepdim=True))
            grew = delta > prev
            hop = grew & (omega <= OMEGA_FLOOR)
            omega_n = torch.where(grew, torch.clamp(omega * 0.5, min=OMEGA_FLOOR),
                                  omega)
            scale_b = torch.amax(torch.abs(u_c2), dim=1, keepdim=True) + inner_eps
            u_c = torch.where(active, u_c2, u_c)
            z_c = torch.where(active, z_c2, z_c)
            omega = torch.where(active, omega_n, omega)
            prev = torch.where(active, delta, prev)
            hopeless = torch.where(active, hop, hopeless)
            scale_u = torch.where(active, scale_b, scale_u)
            active = active & (delta > inner_eps * scale_b) & ~hop
            if not bool(active.any()):
                break

        # ---- untrusted exits (pallas_step.py:593-609): hopeless, non-finite
        # or above tolerance at the sweep cap; poisoned, or with the GMRES
        # rescue solved again exactly (:732-764)
        bad = hopeless | ~(prev < math.inf) | (prev > inner_eps * scale_u)
        if c.coupling_fixed:  # no exit test: nothing is untrusted
            u_n, z_n = u_c, z_c
        elif not c.gmres_rescue:
            u_n = torch.where(bad, torch.full_like(u_c, math.nan), u_c)
            z_n = z_c
        elif bool(bad.any()):
            u_r, z_r, probes_r, iters = rescue(bad[:, 0])
            gmres_iters[t] = iters
            u_n = torch.where(bad, u_r, u_c)
            z_n = torch.where(bad, z_r, z_c)
            if has_exc:
                v_rel, F_H, u_H = (torch.where(bad, r, g) for r, g in
                                   zip(probes_r, (v_rel, F_H, u_H)))
        else:
            u_n, z_n = u_c, z_c
        # Dirichlet rows (:765-766)
        u_n = u_n * live_t * (it != 0).to(dt) * (itf != N_t).to(dt)
        z_n = z_n * live_l * (it != 0).to(dt) * (itf != N_l).to(dt)

        # ---- readout (pallas_step.py:768-787) -------------------------------
        if c.surface_integral:
            w_out = 0.5 * h_t
            if has_exc:
                h_w = hmask if c.has_hammer else 0.0
                b_w = bmask if c.has_bow else 0.0
                w_out = w_out * (1.0 + h_w + b_w)
            u_out = torch.sum(u_n - u1s, dim=1, keepdim=True) * w_out / k
            z_out = torch.sum(z_n - z1s, dim=1, keepdim=True) * w_out / k
        else:
            def pickup(x, N, h):
                ri = 1.0 + torch.floor(N * pos)
                rf = 1.0 + pos / h - ri
                tap = lambda j: torch.sum((itf == j).to(dt) * x, dim=1, keepdim=True)
                return (1.0 - rf) * tap(ri) + rf * tap(ri + 1.0)

            u_out = pickup(u_n, N_t, h_t)
            z_out = pickup(z_n, N_l, h_l)
        uout[:, t : t + 1] = u_out
        zout[:, t : t + 1] = z_out
        if c.collect_state:
            state_u[t] = u_n[:, : c.M_t]
            state_z[t] = z_n[:, : c.M_l]
        if has_exc:  # probe traces and the uHs carry (pallas_step.py:791-802)
            if not c.has_hammer:  # free ballistic hammer displacement
                u_H = torch.clamp(2.0 * uH1 - uH2 - M_HD_CLAMP, min=0.0) + M_HD_CLAMP
            traces["v_r"][:, t : t + 1] = v_rel
            traces["F_H"][:, t : t + 1] = F_H
            traces["u_H"][:, t : t + 1] = u_H
            uH2, uH1 = uH1, u_H
        u2s, u1s = u1s, u_n
        z2s, z1s = z1s, z_n

    aux = {"carry": (u1s[:, : c.M_t], u2s[:, : c.M_t],
                     z1s[:, : c.M_l], z2s[:, : c.M_l]),
           "sweeps": sweeps}
    if c.gmres_rescue:
        aux["gmres_iters"] = gmres_iters
    if has_exc:
        aux.update(traces)
    if c.collect_state:
        aux["state_u"] = state_u
        aux["state_z"] = state_z
    return uout, zout, aux



# the rescue's happy-breakdown guard on a divisor: sqrt(FLT_MIN), as
# pallas_step.py:611 takes it in either precision
_TINY = float(np.finfo(np.float32).tiny) ** 0.5


def _sdiv(a, b):
    """``a / b``, 0 where ``|b|`` is not above ``_TINY`` (happy breakdown)."""
    return torch.where(torch.abs(b) > _TINY,
                       a / torch.where(b == 0.0, torch.ones_like(b), b),
                       torch.zeros_like(a))


def _gmres_fp(op, cvec, live, m):
    """GMRES(m) on ``op(z) = c`` from z = 0 for the strings ``live``
    (pallas_step.py:624-730): modified Gram-Schmidt, Givens rotations,
    back-substitution.  Each string stops on its own once its running
    residual is at most 1e-6 of ``|c|`` (a NaN one stops too), where the
    TPU kernel runs its batch block until every string has.  Returns ``(z,
    relres, iterations)``; ``relres`` and ``z`` are ``(B, 1)`` / ``(B, M)``,
    ``iterations`` the ``(B,)`` Arnoldi count."""
    B = cvec.shape[0]
    col = lambda x: x[:, None]
    beta = torch.sqrt(torch.sum(cvec * cvec, dim=1))
    V = [cvec * col(_sdiv(torch.ones_like(beta), beta))]
    g = [beta] + [torch.zeros_like(beta)] * m
    cs, sn = [], []
    R = [[None] * m for _ in range(m)]  # R[i][j]: row j of column i
    res = beta
    active = live & (res > 1e-6 * beta)
    it_n = torch.zeros(B, dtype=torch.int32, device=cvec.device)
    for i in range(m):
        if not bool(active.any()):
            break
        w = op(V[i])
        hcol = []
        for j in range(i + 1):  # modified Gram-Schmidt, in order
            h = torch.sum(w * V[j], dim=1)
            w = w - col(h) * V[j]
            hcol.append(h)
        hcol.append(None)
        hlast = torch.sqrt(torch.sum(w * w, dim=1))
        V.append(w * col(_sdiv(torch.ones_like(hlast), hlast)))
        for j in range(i):
            hj, hj1 = hcol[j], hcol[j + 1]
            hcol[j] = cs[j] * hj + sn[j] * hj1
            hcol[j + 1] = -sn[j] * hj + cs[j] * hj1
        hi = hcol[i]
        den = torch.sqrt(hi * hi + hlast * hlast)
        ci, si = _sdiv(hi, den), _sdiv(hlast, den)
        hcol[i] = den
        # strings that have stopped keep their rotations, R and g
        keep = lambda new, old: torch.where(active, new, old)
        zero = torch.zeros_like(beta)
        cs.append(keep(ci, zero))
        sn.append(keep(si, zero))
        for j in range(i + 1):
            R[i][j] = keep(hcol[j], zero)
        gi = g[i]
        g[i] = keep(ci * gi, gi)
        g[i + 1] = keep(-si * gi, g[i + 1])
        res = keep(torch.abs(g[i + 1]), res)
        it_n = it_n + active.to(torch.int32)
        active = active & (res > 1e-6 * beta)
    # back substitution on R y = g, then z = V y (pallas_step.py:712-729)
    n = len(cs)
    y = [torch.zeros_like(beta) for _ in range(n)]
    for i2 in range(n - 1, -1, -1):
        s = g[i2]
        for j in range(i2 + 1, n):
            s = s - torch.where(j < it_n, R[j][i2] * y[j], torch.zeros_like(s))
        y[i2] = torch.where(i2 < it_n, _sdiv(s, R[i2][i2]), y[i2])
    z = torch.zeros_like(cvec)
    for i2 in range(n):
        z = torch.where(col(i2 < it_n), z + col(y[i2]) * V[i2], z)
    return z, col(_sdiv(res, beta)), it_n


def _hammer_fixed_point(uH1, uH2, eta0, eta_1, eta_2, f_pow, eps_u, hmask,
                        tol_t, k):
    """Inner hammer fixed point on ``(B, 1)`` scalars (pallas_step.py:473-500).
    At least one iteration; a string stops once its update moves ``eta`` by
    no more than ``tol_t`` (a NaN update stops it too) or after
    ``HAMMER_MAX_ITER``.  Returns ``(F_H, u_H)``."""
    F_H = u_H = torch.zeros_like(eta0)
    eta = eta0
    active = torch.ones_like(eta0, dtype=torch.bool)
    for _ in range(HAMMER_MAX_ITER):
        f_H = f_pow * (eta + eta_2) / 2.0
        F_n = torch.where(eta_1 > 0, f_H, torch.zeros_like(f_H))
        u_n = 2.0 * uH1 - uH2 - k**2 * F_n
        u_n = torch.clamp(u_n - M_HD_CLAMP, min=0.0) + M_HD_CLAMP
        eta_n = (u_n - eps_u) * hmask
        res = torch.abs(eta - eta_n)
        F_H = torch.where(active, F_n, F_H)
        u_H = torch.where(active, u_n, u_H)
        eta = torch.where(active, eta_n, eta)
        active = active & (res > tol_t)
        if not bool(active.any()):
            break
    return F_H, u_H


def _launch_cuda(c: KernelConsts, f0, kappa, alpha, pos, t60, u1, u2, z1, z2,
                 bow, hammer, p_a=None, groups=None, out=None, clocks=None):
    """Check the inputs, allocate the outputs (or take those of ``out``, a
    whole-batch ``(uout, zout, aux)``, and write in place) and launch
    ``string_step``: once over the batch, or once per width group ``(W_g,
    rows)`` of ``groups``, each group on its own stream, joined to the
    current stream before the outputs are returned.  With ``clocks``, a
    ``(B, len(CLOCK_PHASES) + 1)`` int64 tensor, launch the instrumented
    build instead, which writes its cycle and sweep counts there."""
    from . import build

    if (c.manufactured or c.coupling_fixed) and (c.has_bow or c.has_hammer):
        raise NotImplementedError(
            "the CUDA string kernel has MMS and fixed-schedule instances for "
            "plucked strings only (no path runs them with a bow or a hammer); "
            "the plain version (CPU tensors) runs every combination")
    if c.manufactured and c.coupling_fixed:
        raise NotImplementedError(
            "the CUDA string kernel has no instance with both the MMS forcing "
            "and the fixed schedule (no path runs them together)")
    B, T = f0.shape
    W = padded_width(c.M_t, c.M_l)
    shapes = {
        "f0": (f0, (B, T)), "kappa": (kappa, (B,)), "alpha": (alpha, (B,)),
        "pos": (pos, (B,)), "t60": (t60, (B, 2, 2)), "u1": (u1, (B, c.M_t)),
        "u2": (u2, (B, c.M_t)), "z1": (z1, (B, c.M_l)), "z2": (z2, (B, c.M_l)),
    }
    for what, d in (("bow", bow), ("hammer", hammer)):
        for key, x in (d or {}).items():
            if not torch.is_tensor(x):
                raise TypeError(f"{what}[{key!r}] must be a tensor on {f0.device}")
            shape = (B, T) if key in ("x_b", "v_b", "F_b", "wid") else (B,)
            if key == "mask" and x.dtype == torch.bool:
                if x.device != f0.device or tuple(x.shape) != shape:
                    raise ValueError(f"{what}['mask'] must be ({B},) on {f0.device}")
                continue
            shapes[f"{what}[{key!r}]"] = (x, shape)
    if p_a is not None:
        if not torch.is_tensor(p_a):
            raise TypeError(f"p_a must be a tensor on {f0.device}")
        shapes["p_a"] = (p_a, (B,))
    for name, (x, shape) in shapes.items():
        if x.device != f0.device:
            raise ValueError(f"{name} is on {x.device}, f0 on {f0.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA string kernel takes float32; {name} is "
                            f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T < 1 or B < 1:
        raise ValueError(f"empty run: B={B}, T={T}")
    if groups is None:
        groups = [(W, None)]
    for W_g, _ in groups:
        if W_g > 1024:
            raise ValueError(f"grid width {W_g} exceeds one thread block (1024)")

    if clocks is None:
        launch = build.load_kernel_library("string_step").string_step_launch
        launch.argtypes = [ctypes.POINTER(_LaunchArgs), ctypes.c_void_p]
        launch.restype = ctypes.c_int
    else:
        if (clocks.dtype != torch.int64 or clocks.device != f0.device
                or tuple(clocks.shape) != (B, len(CLOCK_PHASES) + 1)
                or not clocks.is_contiguous()):
            raise ValueError(f"clocks must be a contiguous int64 ({B}, "
                             f"{len(CLOCK_PHASES) + 1}) tensor on {f0.device}")
        lib = build.load_kernel_library(*CLOCKS_BUILD)
        if lib.string_step_clock_phases() != len(CLOCK_PHASES):
            raise RuntimeError("the instrumented kernel's phase classes differ from "
                               "CLOCK_PHASES")
        raw = lib.string_step_launch_clocks
        raw.argtypes = [ctypes.POINTER(_LaunchArgs), ctypes.c_void_p, ctypes.c_void_p]
        raw.restype = ctypes.c_int
        launch = lambda args, stream: raw(args, clocks.data_ptr(), stream)
    opts = dict(dtype=torch.float32, device=f0.device)
    if out is None:
        # lanes past a narrower group's width are never written and read 0
        alloc = torch.zeros if any(W_g < W for W_g, _ in groups) else torch.empty
        out = {"uout": torch.empty((B, T), **opts), "zout": torch.empty((B, T), **opts)}
        for name, M in (("u1_out", c.M_t), ("u2_out", c.M_t), ("z1_out", c.M_l),
                        ("z2_out", c.M_l)):
            out[name] = alloc((B, M), **opts)
        if c.has_bow or c.has_hammer:
            for name in ("v_r", "F_H", "u_H"):
                out[name] = torch.empty((B, T), **opts)
        if c.collect_state:
            out["state_u"] = alloc((T, B, c.M_t), **opts)
            out["state_z"] = alloc((T, B, c.M_l), **opts)
    else:
        out = _outputs_in_place(c, B, T, f0.device, out)
    exc = _excitation(f0, bow, hammer, p_a)  # views, masks as 0/1 floats
    ptrs = dict(f0=f0, kappa=kappa, alpha=alpha, pos=pos,
                t60=t60.reshape(B, 4),  # (freq1, time1, freq2, time2)
                u1=u1, u2=u2, z1=z1, z2=z2, **exc, **out)
    common = dict(
        struct_size=ctypes.sizeof(_LaunchArgs), T=T, M_t_sem=c.M_t_sem,
        coupling_iters=c.coupling_iters, has_bow=c.has_bow,
        has_hammer=c.has_hammer, surface_integral=c.surface_integral,
        gmres=c.gmres_rescue, manufactured=c.manufactured,
        mms_centered=c.mms_centered, coupling_fixed=c.coupling_fixed,
        B_rows=B, ld_t=c.M_t, ld_l=c.M_l, k=c.k, theta=c.theta_t,
        lambda_c=c.lambda_c, relative_error=c.relative_error,
        **{name: x.data_ptr() for name, x in ptrs.items()},
    )
    by_spec = string_chunked.launches_by_spec
    with torch.cuda.device(f0.device):
        main = torch.cuda.current_stream(f0.device)
        if groups[0][1] is None:
            streams = [main]
        else:
            streams = _side_streams(f0.device, len(groups))
        row_idx = []  # alive until the streams have joined
        for (W_g, rows), stream in zip(groups, streams):
            if rows is None:
                args = _LaunchArgs(B=B, M_t=c.M_t, M_l=c.M_l, W=W_g, rows=None,
                                   **common)
            else:
                rows = np.asarray(rows, np.int32)
                if rows.min() < 0 or rows.max() >= B:
                    raise IndexError(f"group rows outside the batch of {B}")
                idx = torch.as_tensor(rows).to(f0.device)
                row_idx.append(idx)
                stream.wait_stream(main)
                args = _LaunchArgs(B=len(rows), M_t=min(c.M_t, W_g),
                                   M_l=min(c.M_l, W_g), W=W_g,
                                   rows=idx.data_ptr(), **common)
            rc = launch(ctypes.byref(args), stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"string_step launch failed: CUDA error {rc}")
            by_spec[c.name] = by_spec.get(c.name, 0) + 1
        for stream in streams:
            if stream is not main:
                main.wait_stream(stream)
    aux = {"carry": tuple(out[n] for n in ("u1_out", "u2_out", "z1_out", "z2_out"))}
    aux.update({n: out[n] for n in ("v_r", "F_H", "u_H", "state_u", "state_z")
                if n in out})
    return out["uout"], out["zout"], aux


def _outputs_in_place(c, B, T, device, out):
    """The output tensors of a whole-batch ``(uout, zout, aux)``, by the
    kernel's names, checked for the shapes this launch writes."""
    uout, zout, aux = out
    named = dict(zip(("u1_out", "u2_out", "z1_out", "z2_out"), aux["carry"]))
    named.update(uout=uout, zout=zout)
    want = {"uout": (B, T), "zout": (B, T), "u1_out": (B, c.M_t),
            "u2_out": (B, c.M_t), "z1_out": (B, c.M_l), "z2_out": (B, c.M_l)}
    if c.has_bow or c.has_hammer:
        want.update(v_r=(B, T), F_H=(B, T), u_H=(B, T))
    if c.collect_state:
        want.update(state_u=(T, B, c.M_t), state_z=(T, B, c.M_l))
    for name, shape in want.items():
        x = named.get(name, aux.get(name))
        if (x is None or tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"out: {name} must be a contiguous float32 {shape} "
                             f"tensor on {device}")
        named[name] = x
    return named


_STREAMS = {}  # device index -> side streams of the bucketed launch


def _side_streams(device, n):
    """``n`` CUDA streams of ``device``, created once and reused."""
    pool = _STREAMS.setdefault(device.index, [])
    while len(pool) < n:
        pool.append(torch.cuda.Stream(device))
    return pool[:n]
