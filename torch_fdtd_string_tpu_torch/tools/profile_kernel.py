"""Where the string kernel's time goes on the card.

    python -m torch_fdtd_string_tpu_torch.tools.profile_kernel [out_dir]

PyTorch port of the JAX package's ``tools/profile_kernel.py``, a hardware
trace of the bucketed first pass at the bench workload.  ``ncu`` and
``nsys`` do not run where the card is, so two sources:

1. a ``torch.profiler`` trace of ``string_chunked_bucketed``'s first pass
   (poison-only exits, surface integral, sweep cap 24) over the bench
   workload (``tasks/time_experiment.py::build_workload``, 1 s of audio) at
   B=16 and B=256: device time by kernel name, the window's wall and the
   share of it with a kernel running (the chrome traces go to
   ``out_dir``);
2. a per-phase cycle table from the instrumented build of
   ``csrc/string_step.cu`` (``-DSTRING_STEP_CLOCKS``, a library of its own,
   ``ops/string_kernel.py::CLOCKS_BUILD``): thread 0 of each CTA counts the
   clock64() cycles of each phase class of the step loop, over 256 steps of
   four draws: (a) the bench workload at B=4, (b) the first nsynth-like
   batch (B=24, classic, one launch), (k) the same batch through the
   bucketed launch (the fused headline's) and (l) the first batch of the
   corpus recipe (B=48, bucketed).  Per draw: cycles per string-step by
   phase and their shares, sweeps per step, and the kernel's time per 256
   steps from the plain build and from the instrumented one (what the
   counters cost).

Prints a table per draw and, last, one JSON line of everything.  Runs on the
card only and raises without one.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..ops import string_kernel as sk
from ..tasks.time_experiment import build_workload

T_PHASES = 256  # steps of each draw in the cycle table
TRACE_SIZES = (16, 256)
# (tag, what, config overrides or None for the bench workload, bucketed)
DRAWS = (
    ("a", "bench workload B=4", None, False),
    ("b", "nsynth-like B=24, classic", ["experiment=nsynth-like",
                                         "task.fuse_preprocess=false",
                                         "task.num_samples=24", "task.batch_size=24",
                                         "task.length=1.0"], False),
    ("k", "nsynth-like B=24, bucketed", ["experiment=nsynth-like",
                                          "task.num_samples=24"], True),
    ("l", "corpus recipe B=48, bucketed", [
        "experiment=nsynth-like", "task.num_samples=48", "task.batch_size=48",
        "task.save=false", "task.skip_silence=true", "task.rescue_nan=false",
        "task.save_x_stride=32", "task.save_modal=false",
        "task.save_output_wav=false", "task.save_x_offset_jitter=true",
        "task.save_compact_params=true"], True),
)


def profile_device(device=None):
    """The card, unless ``device`` names another; raises without one."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_kernel measures the CUDA kernel and needs a CUDA "
                           "card; torch finds none")
    return device


def bench_args(B, length, device, T=None, collect_state=False):
    """The bench workload's first pass as ``string_chunked``'s args and
    kwargs: steps from 2, ``T`` of them (default: the JAX tool's multiple
    of 512)."""
    carry, _, sp, _, _, _, _, consts = build_workload(B=B, length=length, device=device)[0]
    T = (sp.f0.shape[1] - 2) // 512 * 512 if T is None else T
    args = (sp.f0[:, 2 : 2 + T].contiguous(), sp.kappa, sp.alpha, sp.pos, sp.T60,
            carry.u1, carry.u2, carry.z1, carry.z2)
    return args, dict(k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
                      M_t=consts.M_t, M_l=consts.M_l, coupling_iters=24,
                      surface_integral=True, collect_state=collect_state,
                      gmres_rescue=False)


def config_args(overrides, device, T):
    """The first batch a run with ``overrides`` draws (seed ``proc.seed``),
    as its ``string_chunked`` args and kwargs over the first ``T`` steps."""
    from ..run import CONFIG_DIR
    from ..tasks import simulate
    from ..utils.config import compose

    args = compose(CONFIG_DIR, overrides)
    task = args.task
    kw = simulate.task_kwargs(task)
    theta = kw.pop("theta_t")
    string, bow, hammer, bm, hm, _ = simulate.draw_params(
        args.model.get("excitation") or "random", task.sr, theta, task.length,
        task.batch_size, task.f0_inf, task.alpha_inf, task.lambda_c,
        precision=task.precision, randomize_each=task.randomize_each,
        manufactured=task.manufactured, rng=np.random.default_rng(args.proc.seed), **kw)
    consts = simulate.sim_consts(string, bm, hm, task.sr, theta, task.lambda_c,
                                 relative_order=task.relative_order,
                                 surface_integral=task.surface_integral,
                                 manufactured=task.manufactured, collect_state=True)
    fargs, fkw = simulate.kernel_inputs(string, consts, int(task.length * task.sr),
                                        device, bow, hammer, bm, hm)
    return (fargs[0][:, :T].contiguous(),) + fargs[1:], fkw


def phase_table(counts, steps):
    """The per-phase table of one launch's counts, ``(B, len(CLOCK_PHASES) +
    1)`` (cycles per phase class summed over ``steps`` steps, then the
    sweeps): mean cycles per string-step by phase, their shares of the
    total, the total and the mean sweeps per step."""
    counts = np.asarray(counts, dtype=np.int64)
    n = len(sk.CLOCK_PHASES)
    if counts.ndim != 2 or counts.shape[1] != n + 1:
        raise ValueError(f"counts of shape {counts.shape}, expected (B, {n + 1})")
    string_steps = counts.shape[0] * steps
    per_step = counts[:, :n].sum(axis=0) / string_steps
    total = float(per_step.sum())
    return {"cycles": {name: float(c) for name, c in zip(sk.CLOCK_PHASES, per_step)},
            "share": {name: float(c) / total if total else 0.0
                      for name, c in zip(sk.CLOCK_PHASES, per_step)},
            "cycles_per_step": total,
            "sweeps_per_step": float(counts[:, n].sum()) / string_steps}


def format_table(tag, what, table):
    """Text lines of one draw's :func:`phase_table`."""
    lines = [f"[{tag}] {what}: {table['cycles_per_step']:.0f} cycles per string-step "
             f"(thread 0), {table['sweeps_per_step']:.3f} sweeps per step"]
    for name in sk.CLOCK_PHASES:
        c = table["cycles"][name]
        if c:
            lines.append(f"[{tag}]   {name:<12} {c:10.1f} cycles  {100 * table['share'][name]:5.1f}%")
    return lines


def _cuda_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_profile(device, reps=5):
    """The cycle table of every draw in ``DRAWS`` (``T_PHASES`` steps)."""
    out = {}
    for tag, what, overrides, bucketed in DRAWS:
        args, kw = (bench_args(4, 0.02, device, T_PHASES, collect_state=True)
                    if overrides is None
                    else config_args(overrides, device, T_PHASES))
        hb = tuple(x.cpu().numpy() for x in args[:3])
        sk.string_chunked_clocks(*args, bucketed=bucketed, host_bounds=hb, **kw)
        _, counts = sk.string_chunked_clocks(*args, bucketed=bucketed, host_bounds=hb, **kw)
        table = phase_table(counts.cpu().numpy(), T_PHASES)
        if bucketed:
            plain = lambda: sk.string_chunked_bucketed(*args, host_bounds=hb, **kw)
        else:
            plain = lambda: sk.string_chunked(*args, **kw)
        table["ms"] = _cuda_ms(plain, reps)
        table["ms_clocks"] = _cuda_ms(lambda: sk.string_chunked_clocks(
            *args, bucketed=bucketed, host_bounds=hb, **kw), reps)
        table.update(what=what, B=int(args[0].shape[0]), M_t=kw["M_t"], M_l=kw["M_l"])
        for line in format_table(tag, what, table):
            print(line)
        print(f"[{tag}]   per {T_PHASES} steps: {table['ms']:.3f} ms, instrumented "
              f"{table['ms_clocks']:.3f} ms", flush=True)
        out[tag] = table
    return out


def busy_share(trace_path):
    """Kernel time, the window and the share of it with a kernel running,
    from a chrome trace: the union of the kernel intervals over the span of
    every event.  None where the trace holds no kernel."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        return None
    busy, end = 0.0, -np.inf
    for lo, hi in kernels:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    return {"kernel_us": sum(hi - lo for lo, hi in kernels), "busy_us": busy,
            "window_us": span, "busy_share": busy / span}


def trace(B, device, out_dir, reps=2):
    """``torch.profiler`` over ``reps`` bucketed first passes of the bench
    workload at batch ``B`` (1 s): device microseconds by kernel name and
    the busy share (:func:`busy_share`)."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = bench_args(B, 1.0, device)
    hb = tuple(x.cpu().numpy() for x in args[:3])
    run = lambda: sk.string_chunked_bucketed(*args, host_bounds=hb, **kw)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    path = os.path.join(out_dir, f"trace_b{B}.json")
    prof.export_chrome_trace(path)
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us and "string_step" in evt.key:
            entry = by_name.setdefault(evt.key, {"device_us": 0.0, "count": 0})
            entry["device_us"] += float(us)
            entry["count"] += int(evt.count)
    share = busy_share(path)
    res = {"B": B, "T": int(args[0].shape[1]), "reps": reps, "kernels": by_name,
           "trace": path, **(share or {"busy_share": None})}
    note = ("no device time in the trace: not measured" if share is None else
            f"window {share['window_us'] / 1e3:.1f} ms, kernels busy "
            f"{share['busy_us'] / 1e3:.1f} ms ({100 * share['busy_share']:.1f}%)")
    print(f"[trace] B={B}, {res['T']} steps x {reps}: {note}; by kernel "
          + ", ".join(f"{k[:100]}: {v['device_us'] / 1e3:.1f} ms ({v['count']}x)"
                      for k, v in by_name.items()), flush=True)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else os.path.join("results", "profile_kernel")
    device = profile_device()
    os.makedirs(out_dir, exist_ok=True)
    res = {"device": torch.cuda.get_device_name(device),
           "phases": phase_profile(device),
           "traces": [trace(B, device, out_dir) for B in TRACE_SIZES]}
    print(json.dumps(res, allow_nan=False))
    return res


if __name__ == "__main__":
    main()
