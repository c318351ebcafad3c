"""Time-scaling sweep of the string step: wall time against batch size and
simulated length, for the string kernel and the scan engine.

    python -m torch_fdtd_string_tpu_torch.tasks.time_experiment [out_dir]

PyTorch port of ``torch_fdtd_string_tpu/tasks/time_experiment.py`` (the
reference's ``plot.time_experiment`` machinery, plot.py:821-923, behind the
batch-size and length figure of the ICASSP paper).  Writes
``time_experiment.json``: ``backend`` and ``device`` (where it ran),
``batch`` and ``length``, each a dict of curves ``kernel`` and ``engine``
of ``[x, seconds]`` points, and then, as the JAX package does,
``time_experiment.pdf`` (``utils/plot.py::time_scaling_figure``; with
``plot=False`` the figure is left out, for a host without matplotlib).  The kernel curve times ``pluck_chunked`` (on
the card the CUDA kernel, CUDA events; on the CPU its plain version), the
engine curve the eager scan engine over ``engine_length`` seconds, scaled
to the kernel's length on the batch axis.  A point that fails raises: the sweep
never writes a curve with a point missing.

The device is the CUDA card unless the caller asks for the CPU; without a
card the sweep raises.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..core import params as prm
from ..core.engine import (BowParams, Carry, HammerParams, SimConsts,
                           StringParams, simulate_chunk)
from ..ops import fdm
from ..ops.string_kernel import pluck_chunked
from ..utils import plot as uplot


def build_workload(B=16, length=1.0, sr=48000, seed=7, bowed=False, device=None):
    """The default randomized pluck workload (or its all-bowed variant): the
    port's copy of the JAX package's ``bench.build_workload``, drawing from
    ``np.random.default_rng(seed)`` in the same order, so the two packages
    draw identical strings.  Returns ``((carry, steps, sp, bp, hp, bm, hm,
    consts), B, length, host)``: float32 tensors on ``device`` (the card
    unless it names another, :func:`sweep_device`), ``steps`` the global
    step indices 2..Nt-1, ``host`` the draws' ``(f0, kappa, alpha)`` as
    numpy arrays."""
    device = sweep_device(device)
    rng = np.random.default_rng(seed)
    k = 1.0 / sr
    f0_min, f0_max = 98.0, 440.0
    kappa_max = 0.03
    theta = fdm.get_theta(kappa_max, f0_min, sr)

    pluck_mask = np.full(B, not bowed)
    bow_mask = np.full(B, bowed)
    hammer_mask = np.zeros(B, bool)
    string = prm.sample_string(
        rng, k=k, theta_t=theta, lambda_c=1.0, sr=sr, length=length,
        f0_inf=f0_min, alpha_inf=1.0, batch_size=B, precision="single",
        pluck_batch=not bowed, pluck_mask=pluck_mask, hammer_mask=hammer_mask,
        f0_min=f0_min, f0_max=f0_max, kappa_min=0.01, kappa_max=kappa_max,
        alpha_min=1.0, alpha_max=25.0,
        t60_min_1=10.0, t60_max_1=25.0, t60_min_2=10.0, t60_max_2=30.0,
        p_a_max=0.02, p_x_max=0.5,
    )
    bow = prm.sample_bow(rng, sr=sr, length=length, batch_size=B, precision="single")
    hammer = prm.sample_hammer(rng, sr=sr, length=length, batch_size=B,
                               precision="single", k=k)

    to = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    u1, u2 = fdm.initialize_state_rows(string.u0, string.v0, k)
    M_l = string.Nx_l + 1
    carry = Carry(u1=to(u1), u2=to(u2),
                  z1=torch.zeros((B, M_l), dtype=torch.float32, device=device),
                  z2=torch.zeros((B, M_l), dtype=torch.float32, device=device),
                  uH1=to(hammer.u_H[:, 1]), uH2=to(hammer.u_H[:, 0]))
    sp = StringParams(kappa=to(string.kappa), alpha=to(string.alpha), p_a=to(string.p_a),
                      f0=to(string.f0), pos=to(string.pos), T60=to(string.T60))
    bp = BowParams(x_b=to(bow.x_b), v_b=to(bow.v_b), F_b=to(bow.F_b),
                   phi_0=to(bow.phi_0), phi_1=to(bow.phi_1), wid=to(bow.wid))
    hp = HammerParams(x_H=to(hammer.x_H), w_H=to(hammer.w_H), M_r=to(hammer.M_r),
                      alpha=to(hammer.alpha))
    consts = SimConsts(
        k=k, theta_t=float(theta), lambda_c=1.0, relative_error=4.0,
        M_t=string.Nx_t + 1, M_l=M_l, surface_integral=True, collect_state=False,
        has_bow=bowed, has_hammer=False,
    )
    bm = torch.as_tensor(bow_mask, device=device)
    hm = torch.as_tensor(hammer_mask, device=device)
    steps = range(2, int(sr * length))
    host = (np.asarray(string.f0), np.asarray(string.kappa), np.asarray(string.alpha))
    return (carry, steps, sp, bp, hp, bm, hm, consts), B, length, host


def call_seconds(fn, device):
    """Seconds of one call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _best_seconds(fn, device, reps):
    """Fastest of ``reps`` calls of ``fn`` after one warm-up call."""
    fn()
    return min(call_seconds(fn, device) for _ in range(reps))


def _time_kernel(workload, device, reps=2):
    """Seconds of one ``pluck_chunked`` call over the workload's steps
    trimmed to a multiple of 512, the JAX kernel's time chunk (best of
    ``reps``)."""
    carry, _, sp, _, _, _, _, consts = workload
    T = (sp.f0.shape[1] - 2) // 512 * 512
    f0 = sp.f0[:, 2 : 2 + T].contiguous()
    return _best_seconds(lambda: pluck_chunked(
        f0, sp.kappa, sp.alpha, sp.pos, sp.T60, carry.u1, carry.u2, carry.z1, carry.z2,
        k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c, M_t=consts.M_t,
        M_l=consts.M_l, chunk=512, surface_integral=consts.surface_integral),
        device, reps)


def _time_engine(workload, device, reps=2):
    """Seconds of the eager scan engine over the workload's steps (best of
    ``reps``)."""
    carry, steps, sp, bp, hp, bm, hm, consts = workload
    return _best_seconds(
        lambda: simulate_chunk(carry, steps, sp, bp, hp, bm, hm, consts), device, reps)


def kernel_point(B, length, device, reps=3, sr=48000):
    """One point of the batch and length sweeps (``tools/batch_sweep.py``,
    ``tools/length_sweep.py``): ``pluck_chunked`` over the bench workload
    at batch ``B`` and ``length`` seconds, the fastest of ``reps`` calls
    after a warm-up, credited with the steps it runs (the workload's trimmed
    to a multiple of 512)."""
    workload = build_workload(B=B, length=length, seed=7, device=device)[0]
    wall = _time_kernel(workload, device, reps)
    steps = B * ((int(sr * length) - 2) // 512 * 512)
    return {"B": B, "length_s": length, "audio_s_per_s": steps / sr / wall,
            "string_steps_per_sec": steps / wall, "wall_s": wall, "backend": device.type,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")}


def sweep_device(device=None):
    """The sweep's device: the card unless ``device`` names another; raises
    when the card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the time sweep runs on a CUDA card and torch finds "
                           "none; pass device='cpu' (--cpu on the sweep tools' command "
                           "lines) to time the plain version")
    return device


def run_sweep(out_dir=".", batches=(4, 16, 64, 256), lengths=(0.25, 0.5, 1.0),
              with_engine=True, device=None, batch_length=1.0, engine_length=0.25,
              reps=2, plot=True):
    """The JAX sweep's axes (reference plot.py:826-838): the kernel at each
    batch size over ``batch_length`` seconds and at B=16 over each length;
    the engine at batch sizes up to 16 over ``engine_length`` seconds
    (scaled to ``batch_length``) and at the lengths up to
    ``engine_length``.  Returns the results written to
    ``out_dir/time_experiment.json``; ``plot`` (which needs matplotlib)
    draws ``time_experiment.pdf`` after it."""
    if plot:
        uplot.require("plot")
    device = sweep_device(device)
    results = {"backend": device.type,
               "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                          else "cpu"),
               "batch": {}, "length": {}}
    wl = lambda B, L: build_workload(B=B, length=L, seed=7, device=device)[0]

    curves_b = {"kernel": [], "engine": []}
    for B in batches:
        curves_b["kernel"].append([B, _time_kernel(wl(B, batch_length), device, reps)])
        if with_engine and B <= 16:
            t = _time_engine(wl(B, engine_length), device, reps)
            curves_b["engine"].append([B, t * batch_length / engine_length])
        print(f"[time_experiment] batch={B} done", flush=True)
    results["batch"] = curves_b

    curves_l = {"kernel": [], "engine": []}
    for L in lengths:
        curves_l["kernel"].append([L, _time_kernel(wl(16, L), device, reps)])
        if with_engine and L <= engine_length:
            curves_l["engine"].append([L, _time_engine(wl(16, L), device, reps)])
        print(f"[time_experiment] length={L} done", flush=True)
    results["length"] = curves_l

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time_experiment.json"), "w") as f:
        json.dump(results, f, indent=1)
    if plot:
        # JAX time_experiment.py:115-125: the curves that have points
        uplot.time_scaling_figure(os.path.join(out_dir, "time_experiment.pdf"), {
            "batch size": {k: v for k, v in curves_b.items() if v},
            "length (s)": {k: v for k, v in curves_l.items() if v},
        })
    return results


if __name__ == "__main__":
    run_sweep(sys.argv[1] if len(sys.argv) > 1 else "results/time_experiment")
