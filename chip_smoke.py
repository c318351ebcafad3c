#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. device report (torch/CUDA versions, card name and power limit, nvcc,
   whether triton imports);
2. build the string kernel from ``torch_fdtd_string_tpu_torch/csrc``;
3. kernel against its plain PyTorch version on the card, float32, at
   (a) the B=4 bench-workload draw and (b) the first nsynth-like batch
   (B=24), both over 256 steps, plus a 2,048-step divergence record;
4. the main path: ``python -m torch_fdtd_string_tpu_torch.run
   experiment=nsynth-like task.fuse_preprocess=false`` for one full batch of
   24 one-second strings, checked artifact by artifact.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 48000
# f32 bounds of tests/test_pallas_kernel.py:53-58: f32 rounding compounds
# over 256 steps of the implicit solve
STATE_ATOL, STATE_REL, READOUT_REL = 1.2e-5, 6e-4, 2e-4
ARTIFACTS = {
    "output.wav", "output-u.wav", "output-z.wav", "simulation.npz",
    "string_params.npz", "bow_params.npz", "hammer_params.npz",
    "simulation_config.yaml",
}


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_inputs(B, length, seed, device):
    """The bench workload's pluck draw (bench.py::build_workload) through
    the port's sampler; returns string_chunked's args and kwargs."""
    from torch_fdtd_string_tpu_torch.core import params as prm
    from torch_fdtd_string_tpu_torch.ops import fdm
    from torch_fdtd_string_tpu_torch.tasks import simulate

    rng = np.random.default_rng(seed)
    k = 1.0 / SR
    theta = fdm.get_theta(0.03, 98.0, SR)
    string = prm.sample_string(
        rng, k=k, theta_t=theta, lambda_c=1.0, sr=SR, length=length,
        f0_inf=98.0, alpha_inf=1.0, batch_size=B, precision="single",
        pluck_batch=True, pluck_mask=np.ones(B, bool),
        hammer_mask=np.zeros(B, bool), f0_min=98.0, f0_max=440.0,
        kappa_min=0.01, kappa_max=0.03, alpha_min=1.0, alpha_max=25.0,
        t60_min_1=10.0, t60_max_1=25.0, t60_min_2=10.0, t60_max_2=30.0,
        p_a_max=0.02, p_x_max=0.5,
    )
    none = np.zeros(B, bool)
    consts = simulate.sim_consts(string, none, none, SR, theta, 1.0,
                                 surface_integral=True)
    return simulate.kernel_inputs(string, consts, int(length * SR), device)


def nsynth_inputs(overrides, device):
    """The first batch the main path draws (seed ``proc.seed``)."""
    from torch_fdtd_string_tpu_torch.run import CONFIG_DIR
    from torch_fdtd_string_tpu_torch.tasks import simulate
    from torch_fdtd_string_tpu_torch.utils.config import compose

    args = compose(CONFIG_DIR, overrides)
    task = args.task
    kw = simulate.task_kwargs(task)
    theta = kw.pop("theta_t")
    string, _, _, bm, hm, _ = simulate.draw_params(
        args.model.excitation, task.sr, theta, task.length, task.batch_size,
        task.f0_inf, task.alpha_inf, task.lambda_c, precision=task.precision,
        randomize_each=task.randomize_each, manufactured=task.manufactured,
        rng=np.random.default_rng(args.proc.seed), **kw,
    )
    consts = simulate.sim_consts(
        string, bm, hm, task.sr, theta, task.lambda_c,
        relative_order=task.relative_order,
        surface_integral=task.surface_integral, collect_state=True,
    )
    return simulate.kernel_inputs(string, consts, int(task.length * task.sr),
                                  device)


def truncate(inputs, T):
    args, kwargs = inputs
    return (args[0][:, :T].contiguous(),) + args[1:], kwargs


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(tag, got, ref):
    """Kernel vs plain version: identical NaN masks, f32 bounds on the
    finite values.  Returns the largest absolute difference."""
    uo, zo, aux = got
    ruo, rzo, raux = ref
    worst = 0.0
    pairs = [("uout", uo, ruo, "readout"), ("zout", zo, rzo, "readout"),
             ("state_u", aux["state_u"], raux["state_u"], "state"),
             ("state_z", aux["state_z"], raux["state_z"], "state")]
    for name, g, r, kind in pairs:
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        nan_g, nan_r = np.isnan(g), np.isnan(r)
        if not np.array_equal(nan_g, nan_r):
            raise AssertionError(f"{tag} {name}: NaN masks differ")
        fin = ~nan_r
        if not np.isfinite(g[fin]).all():
            raise AssertionError(f"{tag} {name}: kernel has inf")
        err = float(np.abs(g[fin] - r[fin]).max(initial=0.0))
        scale = float(np.abs(r[fin]).max(initial=0.0))
        worst = max(worst, err)
        ok = (err <= READOUT_REL * scale + 1e-30 if kind == "readout"
              else err <= STATE_ATOL and err <= STATE_REL * scale + 1e-30)
        print(f"    {tag} {name}: max abs err {err:.3e}, scale {scale:.3e}, "
              f"NaN entries {int(nan_r.sum())}")
        if not ok:
            raise AssertionError(f"{tag} {name}: err {err} beyond the f32 bound")
    return worst


def spectral_peak(x, sr):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.fft.rfftfreq(len(x), 1.0 / sr)[np.argmax(spec[1:]) + 1])


def check_item(d, wavio):
    """Artifact set, finite full-length fields; True when the spectral
    peak of output.wav lies within 3% of the item's target f0."""
    names = set(os.listdir(d))
    if names != ARTIFACTS:
        raise AssertionError(f"{d}: artifacts {sorted(names)}")
    z = np.load(os.path.join(d, "simulation.npz"))
    for key in ("uout", "zout", "state_u", "state_z"):
        if not np.isfinite(z[key]).all():
            raise AssertionError(f"{d}: {key} not finite")
    if z["uout"].shape != (SR - 2,) or z["state_u"].shape[0] != SR:
        raise AssertionError(f"{d}: shapes {z['uout'].shape} {z['state_u'].shape}")
    wav, _ = wavio.read(os.path.join(d, "output.wav"))
    f0 = float(np.load(os.path.join(d, "string_params.npz"))["target_f0"][0])
    peak = spectral_peak(np.asarray(wav, np.float64).reshape(-1), SR)
    return abs(peak - f0) <= 0.03 * f0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.ops import build
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        string_chunked,
        string_chunked_reference,
    )
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device report --------------------------------------------------
    card = smi()
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(card)
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[1] nvcc: {nvcc}")
    try:
        import triton

        print(f"[1] triton {triton.__version__} imports")
    except ImportError as err:
        print(f"[1] triton does not import: {err}")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_kernel_library("string_step")
    print(f"[2] string_step built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds.get('string_step', 0.0):.2f} s)")

    # ---- 3. kernel vs plain version on the card, float32 -----------------------
    overrides = ["experiment=nsynth-like", "task.fuse_preprocess=false",
                 "task.num_samples=24", "task.batch_size=24", "task.length=1.0"]
    shape_b = nsynth_inputs(overrides, dev)
    for tag, (args, kwargs) in (
        ("(a) B=4 bench draw", truncate(bench_inputs(4, 0.02, 7, dev), 256)),
        ("(b) nsynth-like B=24", truncate(shape_b, 256)),
    ):
        B, M_t, M_l = args[0].shape[0], kwargs["M_t"], kwargs["M_l"]
        print(f"[3] {tag}: B={B}, M_t={M_t}, M_l={M_l}, T=256")
        got = string_chunked(*args, **kwargs)
        torch.cuda.synchronize()
        ref = string_chunked_reference(*args, **kwargs)
        worst = compare(tag, got, ref)  # the JSON record keeps shape (b)'s
    args, kwargs = truncate(shape_b, 256)
    ms = cuda_ms(lambda: string_chunked(*args, **kwargs), reps=10)
    plain_ms = cuda_ms(lambda: string_chunked_reference(*args, **kwargs), reps=2)
    print(f"[3] per 256 steps at (b): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"[{card}]")
    args, kwargs = truncate(shape_b, 2048)
    g = string_chunked(*args, **kwargs)[2]["state_u"]
    r = string_chunked_reference(*args, **kwargs)[2]["state_u"]
    fin = ~torch.isnan(r)
    div = float((g[fin] - r[fin]).abs().max() / r[fin].abs().max())
    print(f"[3] (b) after 2048 steps: max |kernel - plain| / max|plain| of "
          f"state_u = {div:.3e} (recorded, not asserted)")

    # ---- 4. the main path ------------------------------------------------------
    save_name = "chip_smoke_nsynth"
    root_dir = os.path.join(ROOT, "results")
    shutil.rmtree(os.path.join(root_dir, save_name), ignore_errors=True)
    string_chunked.launches = 0
    t0 = time.perf_counter()
    save_dir = port_run.main(overrides + [
        f"task.root_dir={root_dir}", f"task.save_name={save_name}",
        "task.randomize_name=false",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = string_chunked.launches
    print(f"[4] main path: {launches} kernel launch(es), wall {wall:.2f} s")
    if launches < 1:
        raise AssertionError("the main path did not launch the string kernel")
    with open(os.path.join(save_dir, "skip_stats.json")) as f:
        stats = json.load(f)
    nan_skips = sum(s["nan_final"] for s in stats)
    silent_skips = sum(s["silent"] for s in stats)
    items = sorted(d for d in os.listdir(save_dir)
                   if os.path.isdir(os.path.join(save_dir, d)) and d != "codes")
    written = sum(s["written"] for s in stats)
    if len(items) != written or written < 1:
        raise AssertionError(f"{len(items)} item dirs, {written} written")
    pitched = sum(check_item(os.path.join(save_dir, d), wavio) for d in items)
    if pitched < 1:
        raise AssertionError("no item's spectral peak is within 3% of target_f0")
    print(f"[4] {written} items written, artifacts complete and finite; "
          f"{pitched} of {written} with the spectral peak within 3% of target_f0; "
          f"NaN skips {nan_skips}, silence skips {silent_skips}")
    args, kwargs = shape_b
    B, T = args[0].shape
    kernel_ms = cuda_ms(lambda: string_chunked(*args, **kwargs), reps=1)
    audio_s = B * 1.0
    print(f"[4] kernel alone at B={B}, T={T}: {kernel_ms:.1f} ms = "
          f"{audio_s / (kernel_ms / 1e3):.1f} audio-s/s, "
          f"{B * T / (kernel_ms / 1e3):.4g} string-steps/s [{card}]")
    with open(os.path.join(save_dir, "gpu_time.txt")) as f:
        sim_s = sum(float(line.split("\t")[1]) for line in f)
    print(f"[4] whole run: {wall:.2f} s for {audio_s:.0f} audio-s = "
          f"{audio_s / wall:.2f} audio-s/s; of it simulate() (draws, kernel, "
          f"state to host) {sim_s:.2f} s, the rest set-up and artifact "
          f"writers [{card}]")

    print(json.dumps({"kernels": [{
        "name": "string_step", "route": "cuda",
        "source": "torch_fdtd_string_tpu_torch/csrc/string_step.cu",
        "replaces": "torch_fdtd_string_tpu/ops/pallas_step.py:113",
        "launches": launches, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
