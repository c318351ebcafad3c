#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab [--float64] CHECKOUT [CHECKOUT ...]
    python3 chip_smoke.py --sharded

Phases; any failure exits non-zero:

1. device report (torch/CUDA versions, card name and power limit, nvcc,
   whether triton imports);
2. build the string kernel from ``torch_fdtd_string_tpu_torch/csrc``;
3. kernel against its plain PyTorch version on the card, float32, 256 steps,
   one shape per specialization: (a) the B=4 bench-workload pluck draw and
   (b) the first nsynth-like batch (B=24), plus a 1,024-step divergence
   record at (b); (c) the first bowed batch (B=16), (d) the first hammered
   batch (B=24), (e) the first ``model.excitation=null`` batch (B=24, bowed,
   hammered and plucked strings), (f) draw (a) with the interpolated
   pickup readout, (g)-(i) draws (c)-(e) with the pickup readout and (j)
   the first batch of phase 8; the probe traces are compared too.  The
   width-bucketed launch against its plain version and against the
   unbucketed kernel: (k) the first nsynth-like batch (B=24, one group),
   (l) the first batch of the corpus recipe (B=48, several groups), (m) a
   B=48 ``model.excitation=null`` batch; each group's width, size and time;
4. the classic path: ``python -m torch_fdtd_string_tpu_torch.run
   experiment=nsynth-like task.fuse_preprocess=false`` for one full batch of
   24 one-second plucked strings, checked artifact by artifact;
5. the same with ``model.excitation=null``: 24 one-second strings, each
   drawn as bowed, hammered or plucked;
6. the bowed path at the JAX bench's ``bow_b16`` shape
   (``model.excitation=bow``, 16 one-second strings);
7. the hammered path (``model.excitation=hammer``, 24 one-second strings);
8. the pickup readout (``task.surface_integral=false``, 4 plucked strings of
   0.25 s);
9. the headline: ``python -m torch_fdtd_string_tpu_torch.run
   experiment=nsynth-like task.num_samples=24`` (fused preprocessing, the
   config's default): every prepared item's wavs and keys, every item from
   the on-device post-processing, the device-to-host bytes against the
   state field's, two items against a host ``build_processed`` of their
   native-width state, the writer phases' times;
10. the corpus recipe at B=48 (``tools/gen_watchdog.py``'s train split):
   8 kept columns per item, compact keys, no run-dir wavs, audio-s/s;
11. the rescue ladder, fused: the corpus recipe with ``task.rescue_nan=true``
   (B=48), at a length cut to 64 steps past the earliest NaN of a first
   pass over the whole second: at least one first-pass
   NaN, the counter identity per batch, every item finite, every
   f64-rescued item through the host build;
12. the rescue ladder, classic: ``model.excitation=null``, one batch of 24
   drawn so that the first pass poisons a string early, the same length
   rule, checked artifact by artifact, the spliced items' fields finite;
13. the MMS verification run at single precision: ``python -m
   torch_fdtd_string_tpu_torch.run experiment=linear-string
   task.precision=single task.plot=false task.plot_state=false`` (one
   string of 0.2 s through the MMS instance), its artifacts, and its state
   held to the manufactured solution;
14. ``experiment=nonlinear-string`` the same way, its artifacts;
15. ``python -m torch_fdtd_string_tpu_torch.tools.kernel_timing``'s
   probe at B=16 and B=256: the adaptive and the fixed sweep schedules'
   walls and deviations;
16. the time-scaling sweep ``tasks/time_experiment.run_sweep`` at the JAX
   axes (kernel only: B 4/16/64/256 at 1 s, lengths 0.25/0.5/1.0 s at
   B=16), every point present, and one engine point (B=4, short) for its
   ms per step.

17. the DMSP serving path on phase 10's corpus: the port's
   ``tools/make_splits`` (8 strings to valid, the rest to test); for
   ``model.mode_estimator=mlp`` and ``physics``, ``experiment=synth-dmsp``
   at full width built from a seeded generator and checkpointed with the
   port's ``save_checkpoint`` (untrained weights), then ``python -m
   torch_fdtd_string_tpu_torch.run experiment=synth-dmsp proc.train=false
   proc.test=true task.plot=false`` through ``run.main``: both score
   tables complete and finite, no partial table left, the logged test
   metrics finite; one batch of 256 through the model on the card and on
   the CPU with the noise fixed (the estimator's and the blocks' outputs
   within the CPU tests' float32 bounds, the waveform within the phase-sum
   bound); the forward's stages timed with CUDA events (the estimator and
   the FM/AM blocks, ``modal_synth``, the noise branch) beside the host
   scoring; the modal baseline's rows recomputed on the CPU; then the
   float64 repair: ``experiment=linear-string`` at its own double
   precision (480 steps) on the card and with ``proc.cpu=true``, the
   written ``state_u`` within 1e-9 of scale, ms per step on each.
18. DMSP training at synth-dmsp's full width: a fresh corpus of phase 10's
   recipe (two batches of 48, ``proc.seed=1818``), split by
   ``tools/make_splits`` (8 strings to valid, 8 to test, the rest to
   train); ``python -m torch_fdtd_string_tpu_torch.run
   experiment=synth-dmsp proc.train=true proc.test=true task.plot=false
   model.mode_estimator=physics task.total_epoch=2`` through ``run.main``
   (batch 128, radam under noam): the step count, ``profile.json``, every
   valid and test record finite, ``BEST``, ``step_<n>.pt`` and
   ``optstate_<n>.pt``, both score tables complete and finite, the device
   cache's bytes and build time; then ``task.resume=true
   task.total_epoch=3``: the step goes on, the optimizer state loaded
   equals the saved one bit for bit, its first learning rate is
   ``schedule(step)``; one train step card against CPU for mlp and
   physics at batch 128 (float64 per tensor, float32 on the losses and
   the whole gradient), and where the float32 gradient's distance from
   float64 comes from (by criterion, ``modal_synth`` in float64, the FM
   frequencies rounded, l1's floor); the train step's ms (forward,
   backward, optimizer), items/s and peak device memory, with the parent
   commit's forms of the four ops the step now runs in a fixed order
   (``F.interpolate``, ``torch.cumsum``, ``F.pad(mode="reflect")``) and
   with the new ones, in turns; the float32 step under
   ``torch.use_deterministic_algorithms(True)`` in a child process
   (``--deterministic-step``; nothing raised) for mlp and physics; two
   float32 runs of two steps, bit for bit; ``proc.train`` for one epoch
   on one card twice, its valid losses and checkpoint bit for bit.
19. the classic pipeline and presets: (a) ``python -m
   torch_fdtd_string_tpu_torch.run experiment=process_training_data`` on
   phase 4's run (24 strings of 1 s, Nx=256) through ``run.main``: every
   item complete and finite, a second call processing nothing, one item's
   modal bank on the card against its numpy twin, the items against
   phase 9's fused items of the same draws at the JAX bounds (the two
   runs' readouts first); (b) ``experiment=evaluate`` and
   ``proc.summarize=true`` on phase 4's run: 24 finite rows, each YIN
   estimate within 5% of its first mode; (c) a seeded synthetic 1 s
   recording through ``tasks/preprocess_data.py``, then
   ``experiment=nsynth-like task.fuse_preprocess=false
   task.load_config=<presets>`` with ``model.excitation=bow`` and
   ``hammer`` (B=4): ``target_f0`` the preset, the bowed outputs' f0
   tracks on the preset's, the hammered outputs silent (the hammer starts
   at rest), each batch's launch against its plain version over 256 steps.

20. the sharded paths (``parallel/mesh.py``), each rank a process of this
   script (``--rank``) joined by torchrun's variables: (a) phase 9's
   ``experiment=nsynth-like task.num_samples=24`` through ``run.main`` on
   two gloo ranks sharing the card, every run-dir and prepared item equal
   to phase 9's bit for bit, the readouts to phase 4's, rank 0's job files,
   the bucketed launch on each rank (counts set to 0 in each rank just
   before its run and read just after); (b) two synth-dmsp train steps at
   full width on phase 18's corpus, the batch of 128 split 64/64, against
   the single-card steps: float64 parameters within 1e-9 of scale, float32
   losses within 1e-5; (c) a one-rank NCCL group: its start, the port's
   all-reduce and all-gather, one data-parallel step against the plain
   step; (d) on a host of two cards or more, (a) and (b) on NCCL across
   two cards (else a line says it was skipped).  Two ranks on one card
   measure the path, not scaling.

21. the figures and a JAX run on the card's host: without matplotlib
   ``experiment=linear-string task.plot=true`` raises the ImportError
   naming ``task.plot=false`` before any work (with it, a run of 96 steps
   draws the item's figures); without tensorstore, ``proc.test`` on a run
   directory of the JAX package's layout (an orbax ``step_<n>/``) raises
   the ImportError naming ``tools/convert_orbax.py``.

22. the port alone, the profiling scopes and the tools: (a) a copy of
   ``torch_fdtd_string_tpu_torch/`` alone in a directory of its own (no JAX
   package beside it; a process that refuses to import jax or the JAX
   package; its ``build/`` seeded with the kernel library and the root
   table) runs ``python -m torch_fdtd_string_tpu_torch.run
   experiment=nsynth-like`` at 8 strings of 0.25 s, and ``run.main`` the
   same overrides here: every wav and npz of the two runs equal bit for
   bit, the snapshot holding ``configs/``; (b)
   ``utils/profiling.py::device_timer`` around a bucketed launch of phase
   9's first batch within 10% of the launch's CUDA events, in turns, and
   ``trace``'s Chrome trace naming a ``string_step`` kernel; (c)
   ``tools.batch_sweep`` at B 16, 32 and ``tools.length_sweep`` at 0.25,
   0.5 s (B=64), one rep each; (d) ``tools.prebuild_cache`` over phase 18's
   corpus (its caches removed first): each cache equal bit for bit to the
   trainer's own, and the trainer loads it; ``tools.yin_accuracy --n 5``;
   ``tools.attrition_study`` on the card over a 0.0075 s run of phase 12's
   draw with ``task.dump_draws=true task.rescue_nan=false`` (its poisoned
   strings skipped), one control; (e) ``dryrun_train_step`` on the card.

Phases 13-22 run after phase 10 and before the ladder phases 11-12, each
of which runs 64 steps past its first pass's earliest NaN.

Phase 3's plain versions, eager PyTorch and most of its time, run in a
child process of this script (``--phase3-plain``) that starts after the
build and runs phase 3 beside phases 4-18, saving each plain call's result
and time; phase 3 itself runs after phase 18, on a card it has to itself:
its kernel launches, timings and comparisons against the saved results,
each call's arguments held to the saved call's by a digest (so the card's
kernel times in the JSON line are measured alone; the walls of phases 4-18
are not).  The kernel's 22 instances build side by side (ops/build.py).
Phase 18's two deterministic-step children run at once, beside its two
float32 runs; phase 20 runs its first generation group beside the
single-card references, and the training group and the NCCL group at
once.

Phase 2 also prints ptxas's registers and spills of every instance.
Phase 3 adds the GMRES instances (``gmres_rescue=True``) against their
plain version: (n) draw (a) with ``coupling_iters=1``, so every step goes
through GMRES, (o) the strong-coupling corner (alpha=23, f0=392) at the
default cap, (p) the first ``model.excitation=null`` batch with
``coupling_iters=1`` (two passes with bow and hammer); and the re-run as
the ladder launches it, the first pass's NaN rows alone at their bucket
groups' widths, in place: (q) of phase 11's draw and (r) of phase 12's,
each against its plain version (the GMRES instances' JSON record), a
whole-batch GMRES launch (bit for bit) and the first pass (healthy rows
untouched).  (s) the MMS instance against its plain version and the
closed form: the JAX twin's string (f0 220, kappa 0.03, p_a 0.01,
relative_error 8, centered forcing) at 48 kHz over 1,024 steps and at 96
kHz over 2,048, second-order convergence between them, a B=32 batch of
mixed f0 and p_a through the bucketed launch, and the MMS GMRES instance;
then the shapes phases 13 and 14 launch: linear-string's and
nonlinear-string's own draws at single precision (their allocation,
relative_error 8, the uncentered forcing) through the bucketed launch
against its plain version, and linear-string's string through the MMS
GMRES instance.  (t) the fixed sweep schedule (1 and 2 sweeps) on draw (a),
the JAX test's draw (the bench workload at seed 11) and draw (b) against
its plain version and, two sweeps, against the adaptive kernel (held on
the JAX test's draw, printed on the others beside the float64 plain
version's own deviation on draw (a)); on draw (a) the adaptive and fixed-2
results held to the float64 plain version at the f32 bounds; (u)
``pluck_chunked`` against ``string_chunked`` bit for bit (one
``pluck-gmres`` launch) and against its plain version on draw (a).

Phases 4-16, 19, 20 and 22 each set the launch counts to 0 just before a
run and read them just after.  The line before the last is the kernels' JSON record, one
entry per specialization (the MMS and fixed-schedule instances among them),
one for the bucketed launch, one per GMRES instance the main paths launched
(``pluck_chunked`` launches ``pluck-gmres``); the last line is ``{"ok":
true, "device": {...}}``.

``--ab`` runs phase 3's draws (a)-(m), the GMRES instance at
``coupling_iters=1`` on draws (a) and (e) as (n) and (p) and at the
strong-coupling corner as (o), the MMS twin at 48 kHz as (s), two fixed
sweeps on draw (a) as (t), ``pluck_chunked`` on draw (a) as (u) and the
bench workload at B=256 (more strings than SMs) as (v), in each checkout
given (a directory holding the repository, e.g. an unpacked ``git archive``
of another commit), each in a process of its own with that checkout's inputs
and kernel: CUDA events over 20 calls of 256 steps, one line per checkout
with the times in ms, the card's name and power limit and the checkout's
ptxas report (the kernel is rebuilt from each checkout's source); then each
instance's registers and spill bytes per checkout, against the first
checkout's. Each process saves every output field of every
case; the outputs of every checkout are then held bit for bit to the
first's, the largest difference per case printed. Any difference, an
instance that spills more than in the first checkout, or a checkout
without a ptxas report exits non-zero. Give
two commits in turns (old, new, new, old) to compare them on one card.
With ``--float64``, for a change of the kernel's rounding, the outputs are
held instead to float64, over AB_DRAWS draws of each case: its inputs and
copies whose u1 and u2 move up by one float32 ulp at random entries, all
stacked along the batch axis into one call (:func:`stacked_draws`).  Each
checkout's process runs that call once; the first's also runs its
float64 plain version on the card (the same call, the float32 inputs cast
to float64) and hands it to the later processes.  For each case and saved
field, e is a draw's largest distance from float64; a later checkout
passes if, in the median draw, it lies further than the first checkout
by no more than the larger of phase 3's f32 bound for that field at the
float64 field's scale and float64's own median move under the
perturbations (:func:`draw_rule`), and if it poisons (a NaN in uout) no
more strings that float64 keeps finite over all draws
(:func:`float64_rule`); the unperturbed e of both, both medians, that
median difference, on how many draws the later lies further, the paired
geometric-mean ratio, every draw's e and each string poisoned on one
side only are printed.  It
also fails a later checkout whose mean time over
its runs is above the first's on (a), (b), (k), (l) or (u).

``--sharded`` runs phases 1-2, phase 9's fused run and phase 18's corpus
(what phase 20 compares with), then phase 20: on a host of two cards or
more it runs (d) on two of them.
"""

from __future__ import annotations

import glob
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
# over 256 steps of the implicit solve; F_H as test_pallas_kernel.py:149
STATE_ATOL, STATE_REL, READOUT_REL, FORCE_REL = 1.2e-5, 6e-4, 2e-4, 1e-3
# zout with an excitation: a bowed or hammered string barely excites z (its
# zout is ~1e-5 of its uout) and z's f32 error follows u's.  It is held to
# its own scale, the batch's at 2e-3 (largest reading 7.7e-4) and each
# string's at 5e-2 (largest 5.7e-3; PERF.md): a zout of 0, or one with a
# wrong readout weight, is off by half its scale or more
ZOUT_REL, ZOUT_STRING_REL = 2e-3, 5e-2
# The GMRES instances only: a string's zout is held to at least 1e-6 of its
# uout, what f32 resolves of z beside u; a bowed string's zout can lie
# below it, and there the plain version's own f32 and f64 results differ by
# its whole scale (1.7 of a 4.3e-12 zout under GMRES; PERF.md)
ZOUT_FLOOR = 1e-6
ARTIFACTS = {
    "output.wav", "output-u.wav", "output-z.wav", "simulation.npz",
    "string_params.npz", "bow_params.npz", "hammer_params.npz",
    "simulation_config.yaml",
}
FIELDS = ("uout", "zout", "state_u", "state_z", "v_r_out", "F_H_out", "u_H_out")
NSYNTH = ["experiment=nsynth-like", "task.fuse_preprocess=false",
          "task.num_samples=24", "task.batch_size=24", "task.length=1.0"]
BOW16 = ["model.excitation=bow", "task.num_samples=16", "task.batch_size=16"]
HAMMER, MIX = ["model.excitation=hammer"], ["model.excitation=null"]
PICKUP = ["task.surface_integral=false"]
# phase 8: the pickup reads a displacement, ~60 dB under the surface
# integral's velocity, below the silence gate
PICKUP4 = NSYNTH[:2] + PICKUP + ["task.num_samples=4", "task.batch_size=4",
                                 "task.length=0.25", "task.skip_silence=false"]
# parameters.npz of a prepared item: the headline run (readout copies and
# the modal baseline) and the corpus recipe (compact); the CPU test
# tests/test_torch_simulate_fused.py holds both to the JAX package's items
PREP_KEYS = [
    "F_B", "F_H_out", "M_H", "Nx_l", "Nx_t", "T60", "a_H", "alpha", "bow_mask",
    "f0", "gain", "hammer_mask", "kappa", "mode_amps", "mode_freq", "p_a",
    "ph0_B", "ph1_B", "pluck_mask", "pos", "sig0", "sig1", "t", "target_f0",
    "u0", "u_H", "u_H_out", "ua_f0", "uout", "ut_f0", "v_B", "v_H", "v_r_out",
    "w_H", "wid_B", "x", "x_B", "x_H", "zout",
]
PREP_KEYS_CORPUS = [
    "M_H", "T60", "a_H", "alpha", "bow_mask", "f0", "gain", "hammer_mask",
    "kappa", "mode_amps", "mode_freq", "p_a", "ph0_B", "ph1_B", "pluck_mask",
    "pos", "sig0", "sig1", "t", "u0", "ut_f0", "w_H", "x", "x_H",
]
# phase 9, the README's headline: fused preprocessing is the config's default
FUSED = ["experiment=nsynth-like", "task.num_samples=24"]
# phase 10, the corpus recipe (tools/gen_watchdog.py:31-47, bench.py:361-373)
CORPUS48 = [
    "experiment=nsynth-like", "task.num_samples=48", "task.batch_size=48",
    "task.save=false", "task.skip_silence=true", "task.rescue_nan=false",
    "task.save_x_stride=32", "task.save_modal=false",
    "task.save_output_wav=false", "task.save_x_offset_jitter=true",
    "task.save_compact_params=true",
]
KERNEL_SRC = "torch_fdtd_string_tpu_torch/csrc/string_step.cu"
# the TPU kernel's branch each specialization ports, and its bucketed launcher
REPLACES = {
    "pluck": "torch_fdtd_string_tpu/ops/pallas_step.py:113",
    "bow": "torch_fdtd_string_tpu/ops/pallas_step.py:418",
    "hammer": "torch_fdtd_string_tpu/ops/pallas_step.py:437",
    "mix": "torch_fdtd_string_tpu/ops/pallas_step.py:452",
    "pluck-pickup": "torch_fdtd_string_tpu/ops/pallas_step.py:775",
    "bucketed": "torch_fdtd_string_tpu/ops/pallas_step.py:999",
    "pluck-mms": "torch_fdtd_string_tpu/ops/pallas_step.py:392",
    "pluck-fixed": "torch_fdtd_string_tpu/ops/pallas_step.py:562",
}
GMRES_REPLACES = "torch_fdtd_string_tpu/ops/pallas_step.py:624"
# steps (q) and (r) run past the first pass's earliest NaN (check_rerun)
RERUN_AFTER = 4
# phases 11 and 12, the rescue ladder (task.length is set by ladder_length)
LADDER_FUSED = [o for o in CORPUS48 if not o.startswith("task.rescue_nan")] + [
    "task.rescue_nan=true"]
# phase 12's draw: with proc.seed=97 the first pass poisons a plucked string
# of the model.excitation=null batch (string 8, alpha 22.9) at step 286; the
# GMRES re-run keeps it finite past step 320 but not to step 1500, and the
# f64 stage keeps it finite, so both stages and the splice of the classic
# ladder run.  (A hammered string poisoned at its strike, as with seeds 14,
# 18 or 20, is kept finite by the re-run alone.)
LADDER_CLASSIC = ["experiment=nsynth-like", "task.fuse_preprocess=false",
                  "task.rescue_nan=true", "model.excitation=null",
                  "task.num_samples=24", "task.batch_size=24", "proc.seed=97"]
# steps phases 11 and 12 run past their first pass's earliest NaN
LADDER_PAST = 64
# NVIDIA H100 SXM data sheet: HBM rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# float operations per live grid point that the step needs: the per-step
# RHS, stencils, interpolations and tridiagonal coefficients (145,
# counted in csrc/string_step.cu) and the two systems' factorization as a
# Thomas solve that reuses it (4 each: the multiplier, the pivot and its
# reciprocal); per sweep the z interpolation, relaxation and residuals (38)
# and two right-hand-side solves (4 each: the forward and the back
# substitution).  The partitioned solve's own extra work, and its reduced
# system, are the kernel's cost, not the function's, and are not counted.
OPS_FACTOR, OPS_SOLVE = 4, 4
OPS_STEP, OPS_SWEEP = 145 + 2 * OPS_FACTOR, 38 + 2 * OPS_SOLVE
# of OPS_SWEEP, the adaptive loop's relaxation of u and z and its three
# residual terms, which a fixed-schedule sweep does not compute
OPS_RELAX = 12
# per Arnoldi iteration of the GMRES rescue and lane: the matvec (one
# RHS-free sweep: two interpolations and stencils, two right-hand-side
# solves of OPS_SOLVE), w = v - Gv, the new row's norm and scaling, and at
# least one modified Gram-Schmidt row (dot product and update, 4)
OPS_ARNOLDI = 34 + 2 * OPS_SOLVE
# per lane and step of the MMS forcing (csrc/string_step.cu): x_u (6), the
# u and the z forcing (11 each, counting each cosf as one operation) and
# their k^2 scaling and subtraction (2 each)
OPS_MMS = 32
# phases 13-14: the verification experiments at single precision
LINEAR = ["experiment=linear-string", "task.precision=single", "task.plot=false",
          "task.plot_state=false"]
NONLINEAR = ["experiment=nonlinear-string"] + LINEAR[1:]
# phase 13's bound on the written state_u against the manufactured solution,
# max over steps and x of |u - u_exact| / p_a: fixed before the card run
# from the plain version's reading on the CPU (proc.cpu=true, the same
# overrides; PERF.md)
MMS_RUN_BOUND = 0.02
# phase 17: synth-dmsp at full width scoring phase 10's corpus, 8 strings
# held out to valid; the float32 bounds of the CPU tests
# (tests/test_torch_dmsp_modules.py: PHASE_FREE_BOUND for the estimators'
# modes and the blocks' freq_m / coef_m, WAVE_BOUND for the waveform of
# the full-width model over 1 s); WAVE64_BOUND for the waveform of the
# untrained mlp run in float64 on its own modes, card against CPU (10x the
# 2.5e-11 the card read, PERF.md); the score rows
# (card against CPU scoring) at 1e-6, and linear-string's float64 state on
# the card and the CPU at 1e-9 of scale
DMSP = ["experiment=synth-dmsp", "proc.train=false", "proc.test=true", "task.plot=false"]
DMSP_VALID, DMSP_BATCH = 8, 256
PHASE_FREE_BOUND, WAVE_BOUND, WAVE64_BOUND = 2.5e-4, 2e-3, 2.5e-10
MODALS_ATOL, F64_REL = 1e-6, 1e-9
F64_RUN = ["experiment=linear-string", "task.length=0.01", "task.plot=false",
           "task.plot_state=false"]
# phase 18: DMSP training at synth-dmsp's full width on a fresh corpus of
# phase 10's recipe, two batches of 48 under another seed (phase 17's split
# stays as it is): 8 strings each to valid and test, the rest to train;
# physics (r5b's estimator), batch 128.  One train step card against CPU
# at the main path's batch of 128: float64 losses LOSS64, per-tensor
# gradients GRAD64 and parameters after the step PARAM64 (the same
# algorithm on both devices; fixed before the first reading); float32
# losses at the CPU tests' LOSS32 (tests/test_torch_dmsp_train.py), the
# float32 whole gradient card against CPU within GRAD32 of its scale
# (2.5x the first reading at B=128, mlp's; physics reads 1.5x it,
# PERF.md), and the card's float32 gradient no further from float64 than
# F32_RATIO times the CPU's (+1e-3)
TRAIN_CORPUS = [o for o in CORPUS48 if not o.startswith("task.num_samples")] + [
    "task.num_samples=96", "proc.seed=1818"]
DMSP_TRAIN = ["experiment=synth-dmsp", "proc.train=true", "proc.test=true", "task.plot=false",
              "model.mode_estimator=physics"]
DMSP_TRAIN_HELD, DMSP_TRAIN_BATCH = 8, 128
LOSS64, GRAD64, PARAM64, LOSS32, GRAD32, F32_RATIO = 1e-9, 1e-6, 1e-7, 5e-4, 0.4, 3.0
# phase 19: the device modal bank against its numpy twin (the CPU test's
# bound, tests/test_torch_process_training_data.py), the preset runs (B=4,
# 1 s) and the bound on a bowed preset string's output f0 track, the
# median over voiced frames of |track / preset - 1|, fixed before the first
# card run
BANK_NP_BOUND, PRESET_F0_REL = 1e-5, 0.03
PRESETS = ["experiment=nsynth-like", "task.fuse_preprocess=false", "task.num_samples=4",
           "task.batch_size=4", "task.length=1.0"]
# phase 22: the package run alone (a copy of torch_fdtd_string_tpu_torch/
# with no JAX package beside it) and from the repository, at a cut size of
# the headline; the profiling scope against CUDA events; the tools.  The
# attrition run is phase 12's draw (proc.seed=97, whose mix batch the first
# pass poisons at step 286; the item names drawn from the run's generator
# would move the draws, so they are fixed as in phase 12) with the skip
# recipe, cut past the poisoning
ALONE = ["experiment=nsynth-like", "task.num_samples=8", "task.batch_size=8",
         "task.length=0.25", "task.randomize_name=false"]
TIMER_REL = 0.1
ATTRITION_RUN = [o for o in LADDER_CLASSIC if not o.startswith("task.rescue_nan")] + [
    "task.rescue_nan=false", "task.dump_draws=true", "task.save=false", "task.length=0.0075",
    "task.randomize_name=false"]
# a process that refuses every import of jax and of the JAX package
REFUSE_JAX = """
import importlib.abc, runpy, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "torch_fdtd_string_tpu"):
            raise ImportError(f"the standalone port imported {name}")
sys.meta_path.insert(0, Refuse())
sys.argv = ["run"] + sys.argv[1:]
runpy.run_module("torch_fdtd_string_tpu_torch.run", run_name="__main__")
"""
# phase 3 (b)'s divergence record, kernel against plain version: 2,048
# steps until phase 22 came in and the plain version's ~20 s per 1,024
# steps went to it
DIVERGENCE_STEPS = 1024
# phase 16's engine point (batch, seconds): the eager engine takes tens of
# ms per step on the card
ENGINE_POINT = (4, 0.005)
# phase 3 (s): the JAX MMS twin's stiffness and loss spec (T60 20 s at 1 kHz
# and at 100 Hz)
MMS_KAPPA, MMS_T60 = 0.03, [[1000.0, 20.0], [100.0, 20.0]]
# phase 3 (s): the closed form within 2% of p_a at 48 kHz, and the 96 kHz
# run at least 1.7 times closer (tests/test_pallas_kernel.py:208-216); the
# f32 plain version meets both on the CPU (PERF.md)
MMS_TWIN_BOUND, MMS_ORDER_RATIO = 0.02, 1.7
# phase 3 (t): the fixed schedule against the adaptive kernel at the JAX
# test's bounds, on its draw (tests/test_pallas_kernel.py:219-246: the bench
# workload at seed 11)
FIXED_STATE_REL, FIXED_UOUT_REL = 2e-4, 2e-3


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_inputs(B, length, seed, device, surface_integral=True):
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
                                 surface_integral=surface_integral)
    return simulate.kernel_inputs(string, consts, int(length * SR), device)


def nsynth_draw(overrides):
    """The first batch the main path draws (seed ``proc.seed``): ``(task,
    (string, bow, hammer, bow_mask, hammer_mask), consts)``."""
    from torch_fdtd_string_tpu_torch.run import CONFIG_DIR
    from torch_fdtd_string_tpu_torch.tasks import simulate
    from torch_fdtd_string_tpu_torch.utils.config import compose

    args = compose(CONFIG_DIR, overrides)
    task = args.task
    kw = simulate.task_kwargs(task)
    theta = kw.pop("theta_t")
    model_name = args.model.get("excitation") or "random"  # as run.py maps it
    string, bow, hammer, bm, hm, _ = simulate.draw_params(
        model_name, task.sr, theta, task.length, task.batch_size,
        task.f0_inf, task.alpha_inf, task.lambda_c, precision=task.precision,
        randomize_each=task.randomize_each, manufactured=task.manufactured,
        rng=np.random.default_rng(args.proc.seed), **kw,
    )
    consts = simulate.sim_consts(
        string, bm, hm, task.sr, theta, task.lambda_c,
        relative_order=task.relative_order,
        surface_integral=task.surface_integral, manufactured=task.manufactured,
        collect_state=True,
    )
    return task, (string, bow, hammer, bm, hm), consts


def nsynth_inputs(overrides, device):
    """string_chunked's args and kwargs for :func:`nsynth_draw`'s batch."""
    from torch_fdtd_string_tpu_torch.tasks import simulate

    task, (string, bow, hammer, bm, hm), consts = nsynth_draw(overrides)
    return simulate.kernel_inputs(string, consts, int(task.length * task.sr),
                                  device, bow, hammer, bm, hm)


def strong_inputs(T, device, B=2):
    """The strong-coupling corner (alpha=23, f0=392, kappa=0.03, a pluck of
    0.01 at 0.4), the golden fixture's strings
    (tests/test_golden_reference.py::_make_cfg), for ``T`` steps."""
    from torch_fdtd_string_tpu_torch.core.params import triangular_np
    from torch_fdtd_string_tpu_torch.ops import fdm

    f0v, kappa, alpha = 392.0, 0.03, 23.0
    k = 1.0 / SR
    theta = fdm.get_theta(kappa, f0v, SR)
    _, _, nx_t, _, nx_l, _ = fdm.get_derived_vars_np(f0v, 0.0, k, theta, 1.0, 1.0)
    _, _, N_t, _, _, _ = fdm.get_derived_vars_np(f0v, kappa, k, theta, 1.0, alpha)
    M_t, M_l = nx_t + 1, nx_l + 1
    u0 = triangular_np(M_t, np.full(B, N_t + 1.0), np.full(B, 0.4), np.full(B, 0.01))
    u0 = u0 * (np.arange(M_t)[None, :] < N_t + 1)
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    args = (t(np.full((B, T), f0v)), t(np.full(B, kappa)), t(np.full(B, alpha)),
            t(np.full(B, 0.4)), t(np.tile([[[1000.0, 20.0], [100.0, 20.0]]], (B, 1, 1))),
            t(u0), t(u0), t(np.zeros((B, M_l))), t(np.zeros((B, M_l))))
    return args, dict(k=k, theta_t=float(theta), lambda_c=1.0, M_t=M_t, M_l=M_l,
                      surface_integral=False, collect_state=True, gmres_rescue=True)


def mms_inputs(f0s, sr, T, p_as, device):
    """The JAX MMS twin's strings (tests/test_pallas_kernel.py::_kernel_mms)
    of fundamentals ``f0s`` and amplitudes ``p_as``, float32: the allocation
    of the lowest f0, each string's initial rows p_a cos^2(pi x) on its own
    live grid, the forcing at its centered time level, relative_error 8,
    the first pass's poison-only exits.  Returns string_chunked's args and
    kwargs and each string's N_t."""
    from torch_fdtd_string_tpu_torch.ops.fdm import get_derived_vars_np, get_theta

    f0s, p_as = np.asarray(f0s, np.float64), np.asarray(p_as, np.float64)
    B, k, kappa = len(f0s), 1.0 / sr, MMS_KAPPA
    theta = get_theta(kappa, float(f0s.min()), sr)
    _, _, nx_t, _, nx_l, _ = get_derived_vars_np(float(f0s.min()), 0.0, k, theta, 1.0, 1.0)
    M_t, M_l = int(nx_t) + 1, int(nx_l) + 1
    N_t = np.array([int(get_derived_vars_np(f, kappa, k, theta, 1.0, 1.0)[2]) for f in f0s])
    i = np.arange(M_t)[None, :]
    x = (np.clip(2.0 * i / N_t[:, None], 0.0, 2.0) - 1.0) / 2.0
    u0 = p_as[:, None] * np.cos(np.pi * x) ** 2 * (i < N_t[:, None] + 1)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    args = (t(np.repeat(f0s[:, None], T, axis=1)), t(np.full(B, kappa)), t(np.ones(B)),
            t(np.full(B, 0.5)), t(np.tile(MMS_T60, (B, 1, 1))),
            t(u0), t(u0), t(np.zeros((B, M_l))), t(np.zeros((B, M_l))))
    kwargs = dict(k=k, theta_t=float(theta), lambda_c=1.0, M_t=M_t, M_l=M_l,
                  coupling_iters=24, relative_error=8.0, collect_state=True,
                  manufactured=True, mms_centered=True, p_a=t(p_as), gmres_rescue=False)
    return (args, kwargs), N_t


def mms_error(state_u, f0, sr, N_t, p_a, first_step=2):
    """Largest deviation of ``state_u`` (T, M), rows from ``first_step`` on,
    from the manufactured solution, relative to ``p_a``."""
    from torch_fdtd_string_tpu_torch.core.analytic import manufactured_solution
    from torch_fdtd_string_tpu_torch.utils.audio import T60_to_sigma

    gamma = 2.0 * f0
    sig0 = float(T60_to_sigma(np.array(MMS_T60), np.array([gamma]),
                              np.array([MMS_KAPPA * gamma]))[0][0])
    su = np.asarray(state_u, np.float64)
    exact = manufactured_solution(first_step + su.shape[0], N_t + 1, gamma, sig0, p_a,
                                  sr)[first_step:]
    return float(np.abs(su[:, : N_t + 1] - exact).max() / p_a)


def truncate(inputs, T):
    """The first T steps: f0 and the bow's (B, T) control signals."""
    args, kwargs = inputs
    kwargs = dict(kwargs)
    if "bow" in kwargs:
        kwargs["bow"] = {key: (v[:, :T].contiguous() if v.dim() == 2 else v)
                         for key, v in kwargs["bow"].items()}
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


def time_on_card(fn):
    """``(fn(), milliseconds)`` of one call (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_on_host(fn):
    """``(fn(), milliseconds)`` of one call on the host's clock."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def timed_once(fn):
    """``(fn(), milliseconds)`` of one call (CUDA events); of a plain
    version that :class:`PlainCalls` replays, the milliseconds it recorded."""
    PlainCalls.last_ms = None
    out, ms = time_on_card(fn)
    return out, ms if PlainCalls.last_ms is None else PlainCalls.last_ms


# the plain versions of ops/string_kernel.py that phase 3 calls
PLAIN_FNS = ("string_chunked_reference", "string_chunked_bucketed_reference",
             "string_chunked_rerun_reference")
# how long the main process waits for phase 3's plain versions once it
# needs them
PLAIN_TIMEOUT_S = 600


def call_key(*values):
    """A digest of a call's arguments: each tensor's and array's dtype,
    shape and bytes, each other value's repr, dicts by sorted key."""
    import hashlib

    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            h.update(f"T{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(x, np.ndarray):
            h.update(f"A{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, dict):
            h.update(b"{")
            for key in sorted(x):
                h.update(repr(key).encode())
                walk(x[key])
            h.update(b"}")
        elif isinstance(x, (list, tuple)):
            h.update(b"(")
            for v in x:
                walk(v)
            h.update(b")")
        else:
            h.update(repr(x).encode())

    walk(values)
    return h.hexdigest()


class PlainChild:
    """The child process (``--phase3-plain``) that records phase 3's plain
    versions into ``results/chip_smoke_3_plain/`` while the main process
    runs phases 4-18; its output goes to ``results/chip_smoke_3_plain.log``.
    It is killed if this process ends first."""

    def __init__(self):
        import atexit

        self.path = os.path.join(ROOT, "results", "chip_smoke_3_plain")
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path)
        self.log_path = self.path + ".log"
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase3-plain", self.path],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT)
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()

    def check(self):
        """Raise if the child has failed."""
        code = self.proc.poll()
        if code not in (None, 0):
            with open(self.log_path) as f:
                tail = f.read()[-6000:]
            raise AssertionError(f"[3] the plain versions' process exited {code}:\n{tail}")

    def wait(self):
        """Wait for the child's end (PLAIN_TIMEOUT_S at most); raise if it
        failed, else return its last line."""
        try:
            self.proc.wait(timeout=PLAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"[3] the plain versions' process outlived "
                                 f"{PLAIN_TIMEOUT_S} s") from None
        self.check()
        self.log.flush()
        with open(self.log_path) as f:
            return f.read().strip().splitlines()[-1]


class PlainCalls:
    """Phase 3's plain versions computed once in a child process
    (``--phase3-plain``) while the main process runs phases 4-18, then read
    back by the main process's phase 3.  Within ``with PlainCalls(mode,
    path)``, each call of a plain version of PLAIN_FNS (looked up on the
    module, as phase 3 calls them) is the next of a sequence: ``record``
    runs it, times it with CUDA events and saves its result, its
    milliseconds and its arguments' :func:`call_key` as ``path/<n>.pt``;
    ``replay`` returns the n-th saved result once the key of its own
    arguments equals the saved one, else raises.  ``timed_once`` reports
    the recorded milliseconds of either."""

    last_ms = None

    def __init__(self, mode, path):
        if mode not in ("record", "replay"):
            raise ValueError(f"mode {mode!r}")
        self.mode, self.path, self.n, self.held = mode, path, 0, {}

    def __enter__(self):
        from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

        for name in PLAIN_FNS:
            self.held[name] = getattr(sk, name)
            setattr(sk, name, self._wrap(name, self.held[name]))
        return self

    def __exit__(self, *exc):
        from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

        for name, fn in self.held.items():
            setattr(sk, name, fn)
        PlainCalls.last_ms = None

    def saved(self):
        """The number of calls saved under ``path``."""
        return len(glob.glob(os.path.join(self.path, "*.pt")))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            n, self.n = self.n, self.n + 1
            key = call_key(name, args, kwargs)
            path = os.path.join(self.path, f"{n:04d}.pt")
            if self.mode == "record":
                timed = time_on_card if torch.cuda.is_available() else time_on_host
                out, ms = timed(lambda: fn(*args, **kwargs))
                torch.save(dict(name=name, key=key, out=out, ms=ms), path)
            else:
                if not os.path.exists(path):
                    raise AssertionError(f"[3] plain call {n} ({name}) was not recorded")
                rec = torch.load(path, weights_only=False)
                if (rec["name"], rec["key"]) != (name, key):
                    raise AssertionError(f"[3] plain call {n} ({name}): its arguments "
                                         f"differ from the recorded call's ({rec['name']})")
                out, ms = rec["out"], rec["ms"]
            PlainCalls.last_ms = ms
            return out

        return call


def compare(tag, got, ref, zout_floor=0.0):
    """Kernel vs plain version: identical NaN masks, f32 bounds on the
    finite values, the probe traces included; with an excitation each
    string's zout is held to its own scale, at least ``zout_floor`` of its
    uout's.  Returns the largest absolute difference."""
    uo, zo, aux = got
    ruo, rzo, raux = ref
    r_uo = ruo.double().cpu().numpy()
    worst = 0.0
    pairs = [("uout", uo, ruo, "readout"), ("zout", zo, rzo, "readout"),
             ("state_u", aux["state_u"], raux["state_u"], "state"),
             ("state_z", aux["state_z"], raux["state_z"], "state")]
    if ("v_r" in raux) != ("v_r" in aux):
        raise AssertionError(f"{tag}: probe traces on one side only")
    if "v_r" in raux:
        pairs += [("v_r", aux["v_r"], raux["v_r"], "readout"),
                  ("u_H", aux["u_H"], raux["u_H"], "readout"),
                  ("F_H", aux["F_H"], raux["F_H"], "force")]
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
        note = ""
        if name == "zout" and "v_r" in raux:
            d = np.where(fin, np.abs(g - r), 0.0).max(axis=1)
            s = np.where(fin, np.abs(r), 0.0).max(axis=1)
            u_s = np.where(np.isnan(r_uo), 0.0, np.abs(r_uo)).max(axis=1)
            s_held = np.maximum(s, zout_floor * u_s)
            rel = float(np.max(d / np.maximum(s_held, 1e-300)))
            ok = err <= ZOUT_REL * scale and bool((d <= ZOUT_STRING_REL * s_held).all())
            note = f", worst per-string err / own scale {rel:.3e}"
        elif kind == "readout":
            ok = err <= READOUT_REL * scale + 1e-30
        elif kind == "force":
            ok = err <= FORCE_REL * max(scale, 1.0)
        else:
            ok = err <= STATE_ATOL and err <= STATE_REL * scale + 1e-30
        print(f"    {tag} {name}: max abs err {err:.3e}, scale {scale:.3e}, "
              f"NaN entries {int(nan_r.sum())}{note}")
        if not ok:
            raise AssertionError(f"{tag} {name}: err {err} beyond the f32 bound")
    return worst


def bound(args, kwargs, sweeps, gmres_iters=None):
    """The least time (ms) the card could take for this string-step call,
    and what bounds it: every input read once and every output written
    once at the HBM rate, or this run's float operations (the plain
    version's sweep counts, and Arnoldi iterations with the GMRES rescue,
    on the same inputs) at the float32 rate; with the MMS forcing its
    per-lane operations, with a fixed schedule the sweeps without the
    adaptive loop's relaxation and residuals."""
    from torch_fdtd_string_tpu_torch.ops.string_kernel import grid_bounds

    f0 = args[0]
    B, T = f0.shape
    M_t, M_l = kwargs["M_t"], kwargs["M_l"]
    exc = [x for d in (kwargs.get("bow"), kwargs.get("hammer")) if d for x in d.values()]
    if kwargs.get("manufactured"):
        exc.append(kwargs["p_a"])
    n_in = sum(x.numel() * x.element_size() for x in list(args) + exc)
    n_out = 4 * (2 * B * T + 2 * B * (M_t + M_l) + T * B * (M_t + M_l)
                 + (3 * B * T if exc else 0))
    bt, bl = grid_bounds(f0.amin(dim=1).cpu().numpy(), args[1].cpu().numpy(),
                         args[2].cpu().numpy(), kwargs["k"], kwargs["theta_t"],
                         kwargs["lambda_c"])
    lanes = np.maximum(bt, bl) - 1  # live grid points, N + 1
    n_sweeps = sweeps.sum(dim=0).cpu().numpy()
    n_arnoldi = 0 if gmres_iters is None else gmres_iters.sum(dim=0).cpu().numpy()
    per_step = OPS_STEP + (OPS_MMS if kwargs.get("manufactured") else 0)
    per_sweep = OPS_SWEEP - (OPS_RELAX if kwargs.get("coupling_fixed") else 0)
    ops = float(np.sum(lanes * (T * per_step + n_sweeps * per_sweep
                                + n_arnoldi * OPS_ARNOLDI)))
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def within_groups(out, groups):
    """An unbucketed result with each string's state and carry lanes past
    its bucket's width set to 0, as the bucketed launch leaves them: the
    unbucketed kernel writes those lanes too, 0 for a healthy string and
    NaN for a poisoned one."""
    uout, zout, aux = out
    aux = dict(aux)
    for key in ("state_u", "state_z"):
        aux[key] = aux[key].clone()
        for w, rows in groups:
            aux[key][:, torch.as_tensor(rows, device=uout.device), w:] = 0.0
    return uout, zout, aux


def named_fields(out):
    """``(name, tensor)`` of every array a string-step call writes."""
    uout, zout, aux = out
    names = ["uout", "zout", "state_u", "state_z", "v_r", "F_H", "u_H"]
    arrays = [uout, zout] + [aux.get(key) for key in names[2:]]
    return ([(n, x) for n, x in zip(names, arrays) if x is not None]
            + list(zip(("u1", "u2", "z1", "z2"), aux["carry"])))


def out_fields(out):
    return [x for _, x in named_fields(out)]


def as_output(arrays, like):
    """``(uout, zout, aux)`` from :func:`out_fields`'s list of copies of
    ``like``'s arrays, with a fresh (T, B) sweep count."""
    named = dict(zip([n for n, _ in named_fields(like)], arrays))
    aux = {key: v for key, v in named.items() if key not in ("uout", "zout", "u1",
                                                             "u2", "z1", "z2")}
    aux["carry"] = tuple(named[key] for key in ("u1", "u2", "z1", "z2"))
    aux["sweeps"] = torch.zeros(named["uout"].shape[::-1], dtype=torch.int32,
                                device=named["uout"].device)
    return named["uout"], named["zout"], aux


def take_rows(out, idx):
    """The rows ``idx`` of a call's outputs, as :func:`compare` reads them,
    with the final carry."""
    uout, zout, aux = out
    part = {key: aux[key][:, idx] for key in ("state_u", "state_z")}
    part.update({key: aux[key][idx] for key in ("v_r", "F_H", "u_H") if key in aux})
    part["carry"] = tuple(c[idx] for c in aux["carry"])
    return uout[idx], zout[idx], part


def inputs_rows(inputs, idx):
    """A call's args and kwargs cut to the strings ``idx``."""
    args, kwargs = inputs
    kwargs = dict(kwargs)
    for key in ("bow", "hammer"):
        if kwargs.get(key):
            kwargs[key] = {k: v[idx] for k, v in kwargs[key].items()}
    return tuple(a[idx] for a in args), kwargs


def host_bounds(args):
    """Host copies of a call's f0, kappa and alpha, for the bucketing."""
    return tuple(x.cpu().numpy() for x in args[:3])


def spectral_peak(x, sr):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.fft.rfftfreq(len(x), 1.0 / sr)[np.argmax(spec[1:]) + 1])


def check_item(d, wavio, n_steps):
    """Artifact set, finite full-length fields; returns the item's
    excitation kind and whether the spectral peak of output.wav lies within
    3% of its target f0."""
    names = set(os.listdir(d))
    if names != ARTIFACTS:
        raise AssertionError(f"{d}: artifacts {sorted(names)}")
    z = np.load(os.path.join(d, "simulation.npz"))
    for key in FIELDS:
        if not np.isfinite(z[key]).all():
            raise AssertionError(f"{d}: {key} not finite")
    for key in ("uout", "zout", "v_r_out", "F_H_out", "u_H_out"):
        if z[key].shape != (n_steps - 2,):
            raise AssertionError(f"{d}: {key} shape {z[key].shape}")
    if z["state_u"].shape[0] != n_steps or z["state_z"].shape[0] != n_steps:
        raise AssertionError(f"{d}: state shapes {z['state_u'].shape} {z['state_z'].shape}")
    kinds = [kind for kind in ("bow", "hammer", "pluck") if z[f"{kind}_mask"]]
    if len(kinds) != 1:
        raise AssertionError(f"{d}: excitation masks {kinds}")
    wav, _ = wavio.read(os.path.join(d, "output.wav"))
    f0 = float(np.load(os.path.join(d, "string_params.npz"))["target_f0"][0])
    peak = spectral_peak(np.asarray(wav, np.float64).reshape(-1), SR)
    return kinds[0], abs(peak - f0) <= 0.03 * f0


def drive(phase, what, overrides, spec, card):
    """One main-path run through the CLI entry point: counts set to 0 just
    before, read just after; every written item checked.  Returns the
    launches of ``spec`` and the run's stats."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        reset_launch_counts,
        string_chunked,
    )
    from torch_fdtd_string_tpu_torch.utils import wav as wavio
    from torch_fdtd_string_tpu_torch.utils.config import compose

    save_name = f"chip_smoke_{phase}"
    root_dir = os.path.join(ROOT, "results")
    shutil.rmtree(os.path.join(root_dir, save_name), ignore_errors=True)
    task = compose(port_run.CONFIG_DIR, overrides).task
    reset_launch_counts()
    t0 = time.perf_counter()
    save_dir = port_run.main(overrides + [
        f"task.root_dir={root_dir}", f"task.save_name={save_name}",
        "task.randomize_name=false",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_spec = dict(string_chunked.launches_by_spec)
    print(f"[{phase}] {what}: kernel launches {by_spec}, wall {wall:.2f} s")
    if by_spec.get(spec, 0) < 1:
        raise AssertionError(f"[{phase}] the {spec} kernel did not launch")
    with open(os.path.join(save_dir, "skip_stats.json")) as f:
        stats = json.load(f)
    items = sorted(d for d in os.listdir(save_dir)
                   if os.path.isdir(os.path.join(save_dir, d)) and d != "codes")
    written = sum(s["written"] for s in stats)
    if len(items) != written or written < 1:
        raise AssertionError(f"[{phase}] {len(items)} item dirs, {written} written")
    n_steps = int(round(task.length * SR))
    kinds, pitched = {}, 0
    for d in items:
        kind, ok = check_item(os.path.join(save_dir, d), wavio, n_steps)
        kinds[kind] = kinds.get(kind, 0) + 1
        pitched += ok
    n = int(task.num_samples // task.batch_size) * int(task.batch_size)
    audio_s = n * float(task.length)
    with open(os.path.join(save_dir, "gpu_time.txt")) as f:
        sim_s = sum(float(line.split("\t")[1]) for line in f)
    print(f"[{phase}] {written} of {n} items written, artifacts complete and "
          f"finite; written by kind {kinds}; {pitched} of {written} with the "
          f"spectral peak within 3% of target_f0; NaN skips "
          f"{sum(s['nan_final'] for s in stats)}, silence skips "
          f"{sum(s['silent'] for s in stats)}")
    print(f"[{phase}] whole run: {wall:.2f} s for {audio_s:g} audio-s = "
          f"{audio_s / wall:.2f} audio-s/s; of it simulate() (draws, kernel, "
          f"state to host) {sim_s:.2f} s [{card}]")
    return by_spec[spec], dict(kinds=kinds, pitched=pitched, wall=wall,
                               audio_s=audio_s, by_spec=by_spec, stats=stats,
                               save_dir=save_dir, items=items, task=task)


def drive_fused(phase, what, overrides, keys, n_cols, card):
    """One fused run through the CLI entry point (launch counts set to 0
    just before, read just after).  Every prepared item is checked: its
    ``n_cols`` ut wavs (and as many ua wavs with the modal baseline),
    ``vt.wav`` and the ``parameters.npz`` keys ``keys``; every written item
    but the f64-rescued ones (``rescued_f64``) must come from the on-device
    post-processing; the device-to-host bytes are held against the state
    field's.  Returns the run's stats."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        reset_launch_counts,
        string_chunked,
        string_chunked_bucketed,
    )
    from torch_fdtd_string_tpu_torch.utils.config import compose

    save_name = f"chip_smoke_{phase}"
    root_dir = os.path.join(ROOT, "results")
    for d in (save_name, save_name + "-prep"):
        shutil.rmtree(os.path.join(root_dir, d), ignore_errors=True)
    task = compose(port_run.CONFIG_DIR, overrides).task
    reset_launch_counts()
    t0 = time.perf_counter()
    save_dir = port_run.main(overrides + [
        f"task.root_dir={root_dir}", f"task.save_name={save_name}",
        "task.randomize_name=false",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = string_chunked_bucketed.launches
    by_spec = dict(string_chunked.launches_by_spec)
    print(f"[{phase}] {what}: bucketed group launches {launches}, by "
          f"specialization {by_spec}, wall {wall:.2f} s")
    if launches < 1:
        raise AssertionError(f"[{phase}] the bucketed launch did not run")
    with open(os.path.join(save_dir, "skip_stats.json")) as f:
        stats = json.load(f)
    written = sum(b["written"] for b in stats["batches"])
    prep = save_dir + "-prep"
    items = sorted(d for d in os.listdir(prep) if os.path.isdir(os.path.join(prep, d)))
    if len(items) != written or written < 1:
        raise AssertionError(f"[{phase}] {len(items)} prepared items, {written} written")
    timing = stats["save_timing"]
    host_built = sum(b["rescued_f64"] for b in stats["batches"])
    n_host = timing.get("host_build", {"n": 0})["n"]
    if timing.get("assemble", {"n": 0})["n"] != written - host_built or n_host != host_built:
        raise AssertionError(f"[{phase}] {host_built} items expected from the host "
                             f"build, the rest from the device path: {timing}")
    n_ua = n_cols if "ua_f0" in keys else 0
    for d in items:
        names = os.listdir(os.path.join(prep, d))
        n_ut = sum(n.startswith("ut-") for n in names)
        n_ua_got = sum(n.startswith("ua-") for n in names)
        if n_ut != n_cols or n_ua_got != n_ua or "vt.wav" not in names:
            raise AssertionError(f"[{phase}] {d}: {n_ut} ut, {n_ua_got} ua wavs, "
                                 f"vt.wav {'vt.wav' in names}")
        z = np.load(os.path.join(prep, d, "parameters.npz"))
        if sorted(z.files) != sorted(keys):
            raise AssertionError(f"[{phase}] {d}: keys {sorted(z.files)}")
        for key in z.files:
            if z[key].dtype.kind == "f" and not np.isfinite(z[key]).all():
                raise AssertionError(f"[{phase}] {d}: {key} not finite")
    run_items = [d for d in os.listdir(save_dir)
                 if os.path.isdir(os.path.join(save_dir, d)) and d != "codes"]
    B = int(task.batch_size)
    n = int(task.num_samples // B) * B
    state_bytes = stats["state_bytes"]
    with open(os.path.join(save_dir, "gpu_time.txt")) as f:
        sim_s = sum(float(line.split("\t")[1]) for line in f)
    phases = ", ".join(f"{k} {v['total_s']:.2f} s ({v['n']}x)" for k, v in timing.items())
    print(f"[{phase}] {written} of {n} items prepared, {written - host_built} from "
          f"the device post-processing; width spread per batch {stats['width_spread']}; "
          f"run-dir items {len(run_items)}; NaN skips "
          f"{sum(b['nan_final'] for b in stats['batches'])}, silence skips "
          f"{sum(b['silent'] for b in stats['batches'])}")
    print(f"[{phase}] device-to-host {stats['link_bytes']} bytes against a state "
          f"field of {state_bytes} bytes ({stats['link_bytes'] / state_bytes:.4f})")
    if not stats["link_bytes"] < 0.5 * state_bytes:
        raise AssertionError(f"[{phase}] the pulls are not far below the state field")
    print(f"[{phase}] whole run {wall:.2f} s for {n * task.length:g} audio-s = "
          f"{n * task.length / wall:.2f} audio-s/s; simulate() {sim_s:.2f} s; writer "
          f"threads: {phases} [{card}]")
    return dict(wall=wall, launches=launches, items=items, save_dir=save_dir,
                run_items=run_items, audio_s=n * task.length, task=task,
                by_spec=by_spec, stats=stats)


def check_host_build(args, kwargs, prep, items, task, card):
    """Two prepared items' ut wavs (device post-processing, f16, PCM_24)
    against ``build_processed`` on the host from the same strings'
    native-width state, recomputed by the same kernel: within 5e-4 of the
    peak (the f16 rounding) plus one PCM_24 step."""
    from torch_fdtd_string_tpu_torch.ops.string_kernel import string_chunked_bucketed
    from torch_fdtd_string_tpu_torch.tasks import process_training_data as ptd
    from torch_fdtd_string_tpu_torch.tasks import simulate
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    theta = simulate.task_kwargs(task)["theta_t"]
    _, _, aux = string_chunked_bucketed(*args, host_bounds=host_bounds(args), **kwargs)
    su = aux["state_u"]
    for d in items[:2]:
        b = int(d.split("-")[1])
        z = np.load(os.path.join(prep, d, "parameters.npz"))
        w = int(z["Nx_t"].max()) + 1
        head = torch.stack([args[6][b, :w], args[5][b, :w]])
        state = torch.cat([head, su[:, b, :w]]).cpu().numpy()
        item = ptd.build_processed(
            {"state_u": state}, {"f0": z["f0"], "kappa": z["kappa"], "T60": z["T60"]},
            {"phi_0": 0.0, "phi_1": 0.0, "wid_B": 0.0}, {"M_r": 0.0, "alpha": 0.0},
            theta, task.lambda_c, SR, 256, strict=False, device_synth=False)
        ut = item["ut"]
        dev = np.stack([np.asarray(wavio.read(os.path.join(prep, d, f"ut-{x}.wav"))[0],
                                   np.float64).reshape(-1) for x in range(256)], axis=1)
        err = float(np.abs(dev - ut).max())
        peak = float(np.abs(ut).max())
        print(f"[9] item {d}: device ut vs host build_processed of its native-width "
              f"state (w={w}): max abs err {err:.3e}, peak {peak:.3e} "
              f"({err / peak:.2e} of it) [{card}]")
        if not err <= 5e-4 * peak + 1.0 / 8388607:
            raise AssertionError(f"[9] item {d}: device ut off the host build")


def check_rerun(tag, inputs, dev, card):
    """The ladder's stage-1 re-run as the main path launches it: the first
    pass's NaN rows of a draw through the GMRES instance alone, at their
    bucket groups' widths, in place.  Held bit for bit to a whole-batch
    GMRES launch, the healthy rows to the first pass, and the re-run rows to
    the plain version of the same re-run at the phase-3 bounds.  Returns the
    instance's name and its JSON record.

    The run ends RERUN_AFTER steps past the first pass's earliest NaN
    within 320 steps: the string the first pass poisons is one whose
    motion diverges there (its state grows ~30x per 8 steps, in float64
    too), and that growth carries the rounding of the GMRES solve's block
    reductions past the phase-3 bounds within a few more steps."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        string_chunked,
        string_chunked_bucketed,
    )

    args, kwargs = truncate(inputs, 320)
    nan = torch.isnan(string_chunked_bucketed(*args, host_bounds=host_bounds(args),
                                              **kwargs)[0])
    if not nan.any():
        raise AssertionError(f"[3] {tag}: the first pass left no NaN row")
    T = int(nan.float().argmax(dim=1)[nan.any(dim=1)].min()) + 1 + RERUN_AFTER
    args, kwargs = truncate(inputs, T)
    hb = host_bounds(args)
    gk = dict(kwargs, gmres_rescue=True)
    first = string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
    rows = torch.nonzero(torch.isnan(first[0].sum(-1)))[:, 0].cpu().numpy()
    idx = torch.as_tensor(rows, device=dev)
    saved = [x.clone() for x in out_fields(first)]
    whole = string_chunked_bucketed(*args, host_bounds=hb, **gk)
    rerun = lambda: sk.string_chunked_rerun(*args, rows=rows, out=first,
                                            host_bounds=hb, **gk)
    sk.reset_launch_counts()
    rerun()
    (spec,) = string_chunked.launches_by_spec
    same = lambda a, b: bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    for (name, a), b in zip(named_fields(first), out_fields(whole)):
        if not same(a, b):
            raise AssertionError(f"[3] {tag} {name}: rows-only re-run differs "
                                 "from the whole-batch GMRES launch")
    healthy = torch.ones(args[0].shape[0], dtype=torch.bool, device=dev)
    healthy[idx] = False
    for a, b in zip(out_fields(first), saved):
        sel = (lambda x: x[:, healthy]) if a.dim() == 3 else (lambda x: x[healthy])
        if not same(sel(a), sel(b)):
            raise AssertionError(f"[3] {tag}: a healthy row changed")
    # the plain version of the same re-run, from the same first pass
    ref, plain_ms = timed_once(lambda: sk.string_chunked_rerun_reference(
        *args, rows=rows, out=as_output(saved, first), host_bounds=hb, **gk))
    worst = compare(tag, take_rows(first, idx), take_rows(ref, idx),
                    zout_floor=ZOUT_FLOOR)
    still = int(torch.isnan(first[0][idx].sum(-1)).sum())
    amp = lambda sel: float(first[2]["state_u"][:, sel].abs().max())
    # both calls are idempotent: the re-run writes the same values again
    rows_ms = cuda_ms(rerun, reps=5)
    whole_ms = cuda_ms(lambda: string_chunked_bucketed(*args, host_bounds=hb, **gk),
                       reps=5)
    iters = ref[2]["gmres_iters"][:, idx]
    bound_ms, bound_by = bound(*inputs_rows((args, gk), idx),
                               ref[2]["sweeps"][:, idx], iters)
    rescued = iters > 0
    print(f"[3] {tag}, T={T}: {spec}, first-pass NaN rows {rows.tolist()}, "
          f"{len(rows) - still} finite after the GMRES instance (max |state_u| "
          f"{amp(idx):.3e} against the healthy rows' {amp(healthy):.3e}); rows-only re-run "
          f"{rows_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}); a whole-batch GMRES launch {whole_ms:.3f} ms, equal in "
          f"every field; healthy rows untouched; string-steps through GMRES "
          f"{int(rescued.sum())} of {rescued.numel()}, mean Arnoldi iterations "
          f"{float(iters[rescued].float().mean()) if rescued.any() else 0.0:.2f} "
          f"[{card}]")
    return spec, dict(max_abs_err=worst, ms=rows_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_mms(dev, card):
    """Phase 3 (s): the MMS instance against its plain version and the
    closed form on the JAX twin's strings."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    errs = []
    for sr, T in ((48000, 1024), (96000, 2048)):
        tag = f"(s) MMS twin, {sr // 1000} kHz, {T} steps"
        (args, kwargs), N_t = mms_inputs([220.0], sr, T, [0.01], dev)
        got = sk.string_chunked(*args, **kwargs)
        ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kwargs))
        worst = compare(tag, got, ref)
        err, err_plain = (mms_error(out[2]["state_u"][:, 0].cpu().numpy(), 220.0, sr,
                                    int(N_t[0]), 0.01) for out in (got, ref))
        ms = cuda_ms(lambda: sk.string_chunked(*args, **kwargs), reps=5) * 256 / T
        bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"])
        bound_ms *= 256 / T
        print(f"[3] {tag}: M_t={kwargs['M_t']}, N_t={int(N_t[0])}; closed-form error "
              f"{err:.4e} of p_a (plain version {err_plain:.4e}); per 256 steps kernel "
              f"{ms:.3f} ms, plain {plain_ms * 256 / T:.1f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}) [{card}]")
        if not err < MMS_TWIN_BOUND:
            raise AssertionError(f"[3] {tag}: closed-form error {err} >= {MMS_TWIN_BOUND}")
        errs.append(err)
    ratio = errs[1] / errs[0]
    print(f"[3] (s) 96 kHz / 48 kHz closed-form error ratio {ratio:.4f} (second order: "
          f"below 1/{MMS_ORDER_RATIO} = {1 / MMS_ORDER_RATIO:.4f})")
    if not ratio < 1.0 / MMS_ORDER_RATIO:
        raise AssertionError(f"[3] (s) the 96 kHz run is not {MMS_ORDER_RATIO}x closer")

    # p_a through the bucketed launch's row map: 32 strings, two widths
    f0s = np.where(np.arange(32) % 2 == 0, 110.0, 330.0)
    p_as = 0.002 + 0.0005 * np.arange(32)
    (args, kwargs), N_t = mms_inputs(f0s, 48000, 256, p_as, dev)
    hb = host_bounds(args)
    groups = sk.bucket_groups(*hb, k=kwargs["k"], theta_t=kwargs["theta_t"],
                              lambda_c=1.0, M_t=kwargs["M_t"], M_l=kwargs["M_l"])
    if len(groups) < 2:
        raise AssertionError(f"[3] (s) bucketed MMS batch in {len(groups)} group")
    tag = "(s) MMS B=32 bucketed"
    got = sk.string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
    ref = sk.string_chunked_bucketed_reference(*args, host_bounds=hb, **kwargs)
    compare(tag, got, ref)
    su = got[2]["state_u"].cpu().numpy()
    worst_cf = max(mms_error(su[:, b], f0s[b], 48000, int(N_t[b]), p_as[b])
                   for b in range(32))
    print(f"[3] {tag}: groups {[(w, len(r)) for w, r in groups]}; worst string's "
          f"closed-form error {worst_cf:.4e} of its p_a")
    if not worst_cf < MMS_TWIN_BOUND:
        raise AssertionError(f"[3] {tag}: a string off its closed form ({worst_cf})")

    # the forcing inside the GMRES instance's passes: every step through it
    tag = "(s) MMS GMRES instance, coupling_iters=1"
    (args, kwargs), _ = mms_inputs([220.0, 262.0], 48000, 256, [0.01, 0.004], dev)
    kwargs = dict(kwargs, gmres_rescue=True, coupling_iters=1)
    check_mms_gmres(tag, (args, kwargs), card)


def check_mms_gmres(tag, inputs, card):
    """The MMS GMRES instance against its plain version over 256 steps.
    Returns its JSON record."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    args, kwargs = inputs
    got = sk.string_chunked(*args, **kwargs)
    ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kwargs))
    worst = compare(tag, got, ref, zout_floor=ZOUT_FLOOR)
    ms = cuda_ms(lambda: sk.string_chunked(*args, **kwargs), reps=3)
    iters = ref[2]["gmres_iters"]
    bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"], iters)
    rescued = iters > 0
    print(f"[3] {tag}: per 256 steps kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); string-steps through GMRES "
          f"{int(rescued.sum())} of {iters.numel()}, Arnoldi iterations of the plain "
          f"version {int(iters.sum())} (mean "
          f"{float(iters[rescued].float().mean()) if rescued.any() else 0.0:.2f}) [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_verification_draws(dev, card):
    """Phase 3 (s), the shapes phases 13 and 14 launch: linear-string's and
    nonlinear-string's own composed draws at single precision (one string
    at the allocation of f0 55 or 60 Hz, relative_order 8; linear-string's
    forcing at the uncentered time level its config leaves) through the
    bucketed launch, against its plain version over their first steps; and
    linear-string's string through the MMS GMRES instance with
    ``coupling_iters=1``, every step through it, as the ladder's re-run
    would launch it there.  Returns the JSON records of the MMS instance
    and of its GMRES instance."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    recs = {}
    for name, overrides, spec, T in (("linear-string", LINEAR, "pluck-mms", 1024),
                                     ("nonlinear-string", NONLINEAR, "pluck", 512)):
        tag = f"(s) {name}'s draw"
        args, kwargs = truncate(nsynth_inputs(overrides, dev), T)
        if kwargs["manufactured"] != (spec == "pluck-mms") or kwargs["mms_centered"]:
            raise AssertionError(f"[3] {tag}: manufactured {kwargs['manufactured']}, "
                                 f"mms_centered {kwargs['mms_centered']}")
        hb = host_bounds(args)
        launch = lambda: sk.string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
        sk.reset_launch_counts()
        got = launch()
        by_spec = dict(sk.string_chunked.launches_by_spec)
        if by_spec != {spec: 1}:
            raise AssertionError(f"[3] {tag}: launches {by_spec}, not one of {spec}")
        ref, plain_ms = timed_once(lambda: sk.string_chunked_bucketed_reference(
            *args, host_bounds=hb, **kwargs))
        worst = compare(tag, got, ref)
        ms = cuda_ms(launch, reps=5) * 256 / T
        bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"])
        bound_ms *= 256 / T
        print(f"[3] {tag}, bucketed, {spec}: B={args[0].shape[0]}, M_t={kwargs['M_t']}, "
              f"M_l={kwargs['M_l']}, relative_error {kwargs['relative_error']:g}, T={T}; "
              f"per 256 steps kernel {ms:.3f} ms, plain {plain_ms * 256 / T:.1f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
        recs[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms * 256 / T,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    args, kwargs = truncate(nsynth_inputs(LINEAR, dev), 256)
    gmres = check_mms_gmres("(s) linear-string's draw, MMS GMRES instance, "
                            "coupling_iters=1",
                            (args, dict(kwargs, gmres_rescue=True, coupling_iters=1)), card)
    return recs["linear-string"], gmres


def check_mms_run(run, card):
    """Phase 13's written state against the manufactured solution: the
    largest deviation over the run, relative to p_a, within MMS_RUN_BOUND."""
    from torch_fdtd_string_tpu_torch.core.analytic import manufactured_solution

    (item,) = run["items"]
    z = np.load(os.path.join(run["save_dir"], item, "simulation.npz"))
    sp = np.load(os.path.join(run["save_dir"], item, "string_params.npz"))
    su = z["state_u"].astype(np.float64)
    n_x = int(z["Nx_t"][0]) + 1
    p_a = float(sp["p_a"])
    exact = manufactured_solution(su.shape[0], n_x, 2.0 * float(sp["f0"][0]),
                                  float(z["sig0"]), p_a, SR)
    err = np.abs(su[:, :n_x] - exact).max(axis=1) / p_a
    print(f"[13] state_u ({su.shape[0]} steps, {n_x} points) against the manufactured "
          f"solution: max {err.max():.4e} of p_a at step {int(err.argmax())}, "
          f"{err[-1]:.4e} at the end; bound {MMS_RUN_BOUND} [{card}]")
    if not err.max() < MMS_RUN_BOUND:
        raise AssertionError(f"[13] state_u off the manufactured solution: {err.max()}")


def cast_inputs(inputs, dtype):
    """A call's args and kwargs with every floating tensor (the bow's and
    hammer's signals and the MMS amplitude among them) cast to ``dtype``."""
    cast = lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
    args, kwargs = inputs
    kwargs = {key: ({k: cast(v) for k, v in v.items()} if isinstance(v, dict) else cast(v))
              for key, v in kwargs.items()}
    return tuple(cast(a) for a in args), kwargs


def ulp_perturbed(args, seed=1):
    """A call's args with the initial rows u1 and u2 each moved up by one
    float32 ulp at random entries (about half, drawn from ``seed``): an
    input change at float32's resolution."""
    rng = np.random.default_rng(seed)
    out = list(args)
    for i in (5, 6):
        x = args[i]
        up = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5).to(x.device)
        out[i] = torch.where(up, torch.nextafter(x, torch.full_like(x, float("inf"))), x)
    return tuple(out)


def stacked_draws(inputs, draws):
    """A call's args and kwargs with ``draws`` copies of every per-string
    input stacked along the batch axis: the inputs as given, then the args
    of :func:`ulp_perturbed` at seeds 1 .. draws - 1 (the bow's, hammer's
    and MMS amplitude's tensors repeated).  No string of the port depends
    on its batch neighbours (every sweep, GMRES and hammer loop exits per
    string), so block i of the stacked call's results is draw i's call."""
    args, kwargs = inputs
    B = args[0].shape[0]

    def tile(x):
        if not torch.is_tensor(x):
            return x
        if x.shape[0] != B:
            raise ValueError(f"a keyword tensor of shape {tuple(x.shape)} in a batch of {B}")
        return torch.cat([x] * draws)

    copies = [args] + [ulp_perturbed(args, seed) for seed in range(1, draws)]
    kwargs = {key: ({k: tile(x) for k, x in v.items()} if isinstance(v, dict) else tile(v))
              for key, v in kwargs.items()}
    return tuple(torch.cat(column) for column in zip(*copies)), kwargs


def stacked_groups(groups, B, draws):
    """The width groups of a batch of ``B`` strings (:func:`bucket_groups`)
    for its :func:`stacked_draws`: every copy of a string in its group, so
    that each runs at its own call's width."""
    return [(w, np.concatenate([np.asarray(rows, np.int64) + i * B for i in range(draws)]))
            for w, rows in groups]


def fixed_gap(adaptive, fixed):
    """Two fixed sweeps against the adaptive schedule, over the strings
    finite in both: the final state's and uout's largest deviations in
    units of the adaptive result's largest value, and the number of those
    strings."""
    fin = torch.isfinite(adaptive[0]).all(dim=1) & torch.isfinite(fixed[0]).all(dim=1)
    a_u1, f_u1 = adaptive[2]["carry"][0][fin], fixed[2]["carry"][0][fin]
    a_uo = adaptive[0][fin]
    return (float((f_u1 - a_u1).abs().max() / (a_u1.abs().max() + 1e-12)),
            float((fixed[0][fin] - a_uo).abs().max() / (a_uo.abs().max() + 1e-12)),
            int(fin.sum()))


def float64_distance(got, ref64):
    """A float32 result against the float64 plain version of the same call,
    over the strings finite in both: the final state's (``carry[0]``) and
    uout's largest absolute differences and the float64 scales of each."""
    fin = torch.isfinite(got[0]).all(dim=1) & torch.isfinite(ref64[0]).all(dim=1)
    out = []
    for g, r in ((got[2]["carry"][0], ref64[2]["carry"][0]), (got[0], ref64[0])):
        g, r = g[fin].double().cpu().numpy(), r[fin].cpu().numpy()
        out += [float(np.abs(g - r).max(initial=0.0)), float(np.abs(r).max(initial=0.0))]
    return tuple(out)


def draw_distances(got, ref64, draws):
    """:func:`float64_distance` of each of ``draws`` stacked draws
    (:func:`stacked_draws`): draw i's rows of ``got`` against the same rows
    of ``ref64``."""
    B = got[0].shape[0] // draws
    return [float64_distance(take_rows(got, slice(i * B, (i + 1) * B)),
                             take_rows(ref64, slice(i * B, (i + 1) * B)))
            for i in range(draws)]


# phase 3 (t)'s float64 hold: the final state's absolute error, that error
# and uout's as shares of their float64 scales, each with its f32 bound
HOLD_QUANTITIES = (("final state abs", STATE_ATOL), ("final state of scale", STATE_REL),
                   ("uout of scale", READOUT_REL))


def float64_hold(rows):
    """Phase 3 (t)'s float64 hold over stacked draws, each draw's
    :func:`float64_distance` a row of ``rows``: per draw the three
    HOLD_QUANTITIES, and the hold passes if the median over the draws of
    each is within its bound.  Two equally accurate roundings part by more
    than a bound on single draws, so one draw does not decide; a loss of
    accuracy on most draws moves the median past the bound (PERF.md).
    Returns the verdict (``ok``), the per-draw values (``values``, draws x
    3), their ``median`` and on how many draws each is within its bound
    (``within``)."""
    r = np.asarray(rows, np.float64).reshape(-1, 4)
    values = np.stack([r[:, 0], r[:, 0] / np.maximum(r[:, 1], 1e-300),
                       r[:, 2] / np.maximum(r[:, 3], 1e-300)], axis=1)
    bounds = np.array([b for _, b in HOLD_QUANTITIES])
    median = np.median(values, axis=0)
    return dict(ok=bool((median <= bounds).all()), values=values, median=median,
                within=(values <= bounds).sum(axis=0))


def check_fixed(draws, card):
    """Phase 3 (t): the fixed schedule (1 and 2 sweeps) against its plain
    version on each draw ``(tag, inputs, hold)``, and two sweeps against
    the adaptive kernel.  ``hold`` is ``"twin"`` on the JAX test's own draw
    (tests/test_pallas_kernel.py:219-246 builds it with seed 11): there the
    deviation is held at that test's bounds.  On the other draws it is
    printed: on draw (a), seed 7, exact arithmetic does not meet those
    bounds (the float64 plain version's own deviation, printed beside it,
    read 2.170e-4 of the state on the CPU; PERF.md), and the nsynth-like
    draw's strongly coupled strings (alpha up to 25) two sweeps do not
    bring to the adaptive fixed point at all.  ``hold`` is ``"float64"`` on
    draw (a): the card's adaptive and fixed-2 results on AB_DRAWS
    :func:`stacked_draws` (the first draw held bit for bit to the loop's
    call) are each held to the float64 plain version of the same schedule
    on the same inputs cast to float64, at the f32 bounds of
    tests/test_pallas_kernel.py:53-58 (final state STATE_ATOL and STATE_REL
    of scale, uout READOUT_REL of scale) in the median draw
    (:func:`float64_hold`).
    Returns the JSON record of the first draw's two sweeps: draw (a), the
    bench workload that phase 15 launches the instance on."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    rec = None
    for tag, inputs, hold in draws:
        args, kwargs = truncate(inputs, 256)
        adaptive = sk.string_chunked(*args, **kwargs)
        for n in (1, 2):
            kw = dict(kwargs, coupling_fixed=n)
            name = f"(t) {tag}, coupling_fixed={n}"
            got = sk.string_chunked(*args, **kw)
            ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kw))
            worst = compare(name, got, ref)
            ms = cuda_ms(lambda: sk.string_chunked(*args, **kw), reps=10)
            bound_ms, bound_by = bound(args, kw, ref[2]["sweeps"])
            dev_state, dev_out, n_fin = fixed_gap(adaptive, got)
            print(f"[3] {name}: per 256 steps kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by}); against the adaptive kernel "
                  f"over {n_fin} finite strings: final state {dev_state:.3e}, "
                  f"uout {dev_out:.3e} of scale [{card}]")
            if (hold == "twin" and n == 2
                    and not (dev_state < FIXED_STATE_REL and dev_out < FIXED_UOUT_REL)):
                raise AssertionError(f"[3] {name}: off the adaptive kernel's fixed point")
            if n == 2 and rec is None:
                rec = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        if hold != "float64":
            continue
        B = args[0].shape[0]
        block0 = lambda out: take_rows(out, slice(0, B))
        stacked = stacked_draws((args, kwargs), AB_DRAWS)
        args64, kw64 = cast_inputs(stacked, torch.float64)
        ref64 = {n: sk.string_chunked_reference(*args64, **dict(kw64, coupling_fixed=n))
                 for n in (0, 2)}
        gap64 = fixed_gap(block0(ref64[0]), block0(ref64[2]))
        print(f"[3] (t) {tag}: the float64 plain version's own fixed-2 against adaptive: "
              f"final state {gap64[0]:.3e}, uout {gap64[1]:.3e} of scale")
        for n, out in ((0, adaptive), (2, got)):  # got: the loop's two sweeps
            what = "adaptive" if n == 0 else "fixed-2"
            draws_out = sk.string_chunked(*stacked[0], **dict(stacked[1], coupling_fixed=n))
            for (name, a), (_, b) in zip(named_fields(block0(draws_out)), named_fields(out)):
                if a.cpu().numpy().tobytes() != b.cpu().numpy().tobytes():
                    raise AssertionError(f"[3] (t) {tag}, {what} {name}: the stacked call's "
                                         "first draw is not the call's result bit for bit")
            rows = draw_distances(draws_out, ref64[n], AB_DRAWS)
            s_err, s_scale, u_err, u_scale = rows[0]
            print(f"[3] (t) {tag}, {what} against its float64 plain version: final state "
                  f"{s_err:.3e} abs, {s_err / s_scale:.3e} of scale; uout "
                  f"{u_err / u_scale:.3e} of scale [{card}]")
            verdict = float64_hold(rows)
            print(f"[3] (t) {tag}, {what} over {AB_DRAWS} draws (the inputs, then u1 and u2 "
                  f"one float32 ulp up, seeds 1-{AB_DRAWS - 1}), the first draw's the call's "
                  f"result bit for bit: {'held' if verdict['ok'] else 'FAILS'} [{card}]")
            for j, (quantity, b) in enumerate(HOLD_QUANTITIES):
                print(f"[3]     {quantity}: median {verdict['median'][j]:.3e} (bound {b:.1e}), "
                      f"within on {verdict['within'][j]}/{AB_DRAWS}; per draw "
                      + " ".join(f"{x:.3e}" for x in verdict["values"][:, j]))
            if not verdict["ok"]:
                raise AssertionError(f"[3] (t) {tag}, {what}: the median draw beyond the f32 "
                                     "bounds of the float64 plain version")
    return rec


def check_pluck_chunked(inputs, card):
    """Phase 3 (u): ``pluck_chunked`` equals ``string_chunked`` with the
    same keywords bit for bit (its default GMRES instance, state collected)
    and its plain version at the phase-3 bounds.  Returns the JSON record of
    the instance it launches, ``pluck-gmres``."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    args, kwargs = truncate(inputs, 256)
    kw = {key: v for key, v in kwargs.items() if key != "gmres_rescue"}
    sk.reset_launch_counts()
    uo, zo, fin = sk.pluck_chunked(*args, **kw)
    if sk.string_chunked.launches_by_spec != {"pluck-gmres": 1}:
        raise AssertionError(f"[3] (u) pluck_chunked launched "
                             f"{sk.string_chunked.launches_by_spec}, not pluck-gmres")
    want = sk.string_chunked(*args, **kw)
    for a, b in zip((uo, zo) + tuple(fin),
                    (want[0], want[1]) + want[2]["carry"]
                    + (want[2]["state_u"], want[2]["state_z"])):
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            raise AssertionError("[3] (u) pluck_chunked differs from string_chunked")
    ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kw))
    worst = compare("(u) pluck_chunked, draw (a)", (uo, zo, {"state_u": fin[4],
                                                             "state_z": fin[5]}), ref)
    ms = cuda_ms(lambda: sk.pluck_chunked(*args, **kw), reps=10)
    bound_ms, bound_by = bound(args, kw, ref[2]["sweeps"], ref[2]["gmres_iters"])
    print(f"[3] (u) pluck_chunked, draw (a): one pluck-gmres launch, equal to "
          f"string_chunked bit for bit; per 256 steps {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def ptxas_report(log):
    """ptxas's resource lines per string_step instance, by specialization
    name, from nvcc's ``-Xptxas=-v`` messages."""
    import re

    exc = {("0", "0"): "pluck", ("1", "0"): "bow", ("0", "1"): "hammer",
           ("1", "1"): "mix"}
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"string_step_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E"
                      r"(?:Lb(\d)ELb(\d)E)?", line)
        if "Compiling entry function" in line:
            name = None
            if m:
                bow, ham, surf, gm, mms, fixed = m.groups()
                name = (exc[(bow, ham)] + ("" if surf == "1" else "-pickup")
                        + ("-mms" if mms == "1" else "") + ("-fixed" if fixed == "1" else "")
                        + ("-gmres" if gm == "1" else ""))
                out[name] = []
        elif name and ("registers" in line or "spill" in line):
            out[name].append(line.replace("ptxas info    :", "").strip())
            if "registers" in line:  # the entry's own report ends here
                name = None
    return out


def ladder_length(phase, overrides, dev, card):
    """The ``task.length`` of a ladder phase: the first pass over the
    config's whole length finds the NaN strings, and the phase runs
    LADDER_PAST steps past the earliest NaN, never longer than the
    config's.  The length follows the draw alone, not the host's speed."""
    from torch_fdtd_string_tpu_torch.ops.string_kernel import string_chunked_bucketed
    from torch_fdtd_string_tpu_torch.tasks import simulate

    task, (string, bow, hammer, bm, hm), consts = nsynth_draw(overrides)
    Nt = int(round(task.length * SR))
    args, kwargs = simulate.kernel_inputs(string, consts, Nt, dev, bow, hammer, bm, hm)
    uo = string_chunked_bucketed(*args, host_bounds=host_bounds(args), **kwargs)[0]
    nan = torch.isnan(uo)
    rows = torch.nonzero(nan.any(dim=1))[:, 0].cpu().numpy()
    if len(rows) == 0:
        print(f"[{phase}] the first pass over {task.length:g} s leaves no NaN string; "
              f"length stays {task.length:g} s")
        return float(task.length)
    first_nan = int(nan[torch.as_tensor(rows, device=dev)].float().argmax(dim=1).min()) + 2
    steps = min(Nt, first_nan + LADDER_PAST)
    length = steps / SR
    print(f"[{phase}] first pass over {task.length:g} s: NaN strings {rows.tolist()}, "
          f"the earliest at step {first_nan}; task.length cut to {length:g} s ({steps} "
          f"steps) [{card}]")
    return length


def check_ladder(phase, batches, task, wall, card, need_nan=False):
    """The ladder's counters: nan_first_pass = rescued_kernel_gmres +
    rescued_f64 + nan_final in every batch; with ``need_nan`` at least one
    first-pass NaN.  Prints them, the f64 stage's seconds per step, the
    run's wall and audio-s/s."""
    keys = ("nan_first_pass", "rescued_kernel_gmres", "rescued_f64", "nan_final")
    for b in batches:
        if b[keys[0]] != b[keys[1]] + b[keys[2]] + b[keys[3]]:
            raise AssertionError(f"[{phase}] batch {b['it']}: counters {b}")
    tot = {key: sum(b[key] for b in batches) for key in keys}
    if need_nan and tot["nan_first_pass"] < 1:
        raise AssertionError(f"[{phase}] no first-pass NaN: the ladder did not run")
    steps = int(round(task.length * SR)) - 2
    f64_s = sum(b.get("rescue_f64_s", 0.0) for b in batches)
    n = len(batches) * int(task.batch_size)
    print(f"[{phase}] ladder counters {tot}; f64 stage {f64_s:.2f} s = "
          f"{f64_s / steps * 1e3:.2f} ms per step over {steps} steps; whole run "
          f"{wall:.2f} s for {n * task.length:g} audio-s = "
          f"{n * task.length / wall:.3f} audio-s/s [{card}]")


def drive_kernel_timing(dev, card):
    """Phase 15: the sweep-schedule probe at its two batch sizes (counts set
    to 0 just before, read just after).  Returns the fixed-schedule
    instance's launches and the launches by specialization."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
    from torch_fdtd_string_tpu_torch.tools import kernel_timing

    sk.reset_launch_counts()
    t0 = time.perf_counter()
    res = kernel_timing.run_timing(reps=3, device=dev)
    wall = time.perf_counter() - t0
    by_spec = dict(sk.string_chunked.launches_by_spec)
    print(json.dumps(res, allow_nan=False))
    for name, row in res.items():
        dev_note = ""
        if "max_rel_dev_vs_adaptive" in row:
            dev_note = (f", max rel dev of uout vs adaptive {row['max_rel_dev_vs_adaptive']:.3e}"
                        f" ({row['nonfinite_strings']} strings left non-finite)")
        print(f"[15] {name}: {row['wall_s'] * 1e3:.2f} ms, {row['audio_s_per_s']:.2f} "
              f"audio-s/s{dev_note} [{card}]")
    print(f"[15] kernel_timing: launches {by_spec}, wall {wall:.2f} s")
    if by_spec.get("pluck-fixed", 0) < 1:
        raise AssertionError("[15] the fixed-schedule instance did not launch")
    return by_spec["pluck-fixed"], by_spec


def drive_time_experiment(dev, card):
    """Phase 16: the time-scaling sweep at the JAX axes, kernel only (counts
    set to 0 just before, read just after), every point present; then one
    engine point.  Returns the launches by specialization: ``pluck_chunked``
    launches the ``pluck-gmres`` instance."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
    from torch_fdtd_string_tpu_torch.tasks import time_experiment as te

    out_dir = os.path.join(ROOT, "results", "chip_smoke_16")
    shutil.rmtree(out_dir, ignore_errors=True)
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    te.run_sweep(out_dir, with_engine=False, device=dev, plot=False)
    wall = time.perf_counter() - t0
    by_spec = dict(sk.string_chunked.launches_by_spec)
    with open(os.path.join(out_dir, "time_experiment.json")) as f:
        res = json.load(f)
    want = {"batch": [4, 16, 64, 256], "length": [0.25, 0.5, 1.0]}
    for axis, xs in want.items():
        points = res[axis]["kernel"]
        if [x for x, _ in points] != xs or not all(np.isfinite(t) and t > 0
                                                   for _, t in points):
            raise AssertionError(f"[16] the {axis} axis: points {points}")
        print(f"[16] {axis} axis, kernel (pluck_chunked): "
              + ", ".join(f"{x}: {t * 1e3:.2f} ms" for x, t in points) + f" [{card}]")
    print(f"[16] time_experiment.json: backend {res['backend']}, device {res['device']}; "
          f"kernel launches {by_spec}, wall {wall:.2f} s")
    if by_spec.get("pluck-gmres", 0) < 1:
        raise AssertionError("[16] pluck_chunked did not launch the pluck-gmres instance")
    # the eager engine takes tens of ms per step: one short point, not the
    # JAX sweep's 0.25 s ones
    B, length = ENGINE_POINT
    wl = te.build_workload(B=B, length=length, device=dev)[0]
    secs = te._time_engine(wl, dev, reps=1)
    print(f"[16] engine point: B={B}, {len(wl[1])} steps in {secs:.2f} s = "
          f"{secs / len(wl[1]) * 1e3:.2f} ms per step [{card}]")
    return by_spec


def read_scores(path):
    """A score table's ids and rows (the mean row last)."""
    with open(path) as f:
        lines = f.read().strip().split("\n")
    rows = [line.split("\t") for line in lines[1:]]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows])


def rel_diff(ref, got):
    ref = ref.detach().double().cpu()
    got = got.detach().double().cpu()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def dmsp_models(load_dir, load_name, dev, card):
    """Phase 17's models: for each estimator the composed args and the
    full-width synth-dmsp model from a seeded generator, checkpointed into
    ``results/chip_smoke_17_<estimator>``; the physics table's build
    timed first."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.models import physmodes
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    out = {}
    for est in ("mlp", "physics"):
        over = DMSP + [f"model.mode_estimator={est}", f"task.load_dir={load_dir}",
                       f"task.load_name={load_name}"]
        args = compose(port_run.CONFIG_DIR, over)
        if est == "physics":
            t0 = time.perf_counter()
            physmodes.mu1_tables(*args.model.kappa_scale)
            built = physmodes.table_build_seconds
            print(f"[17] physics estimator's mu1 table ready in "
                  f"{time.perf_counter() - t0:.2f} s (build "
                  f"{sum(built.values()):.2f} s; 0 when read from build/cache) [{card}]")
        model = S.build_model(args, torch.Generator().manual_seed(17), dev)
        run_dir = os.path.join(ROOT, "results", f"chip_smoke_17_{est}")
        shutil.rmtree(run_dir, ignore_errors=True)
        trainer.save_checkpoint(run_dir, model, 0)
        n_par = sum(p.numel() for p in model.parameters())
        print(f"[17] {est}: synth-dmsp hidden_dim {args.model.hidden_dim}, embed_dim "
              f"{args.model.embed_dim}, n_modes {args.model.n_modes}, n_bands "
              f"{args.model.n_bands}, block_size {args.model.block_size}: {n_par} "
              f"parameters, untrained weights (seed 17) checkpointed")
        out[est] = (over, args, model, run_dir)
    return out


def dmsp_serve(est, over, run_dir, n_items, card):
    """Phase 17, D.3: proc.test through run.main; the score tables and the
    logged metrics checked.  Returns the tables' ids and rows by name."""
    from torch_fdtd_string_tpu_torch import run as port_run

    t0 = time.perf_counter()
    save_dir = port_run.main(over + [f"task.root_dir={os.path.dirname(run_dir)}",
                                     f"task.save_name={os.path.basename(run_dir)}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = os.path.join(save_dir, "score")
    if glob.glob(os.path.join(score, "*partial*")):
        raise AssertionError(f"[17] {est}: a partial score table is left")
    tables = {}
    for name in ("output", "modals"):
        ids, rows = read_scores(os.path.join(score, f"{name}.txt"))
        want = [f"0-{i // DMSP_BATCH}-{i % DMSP_BATCH}" for i in range(n_items)] + ["# mean"]
        if ids != want or rows.shape != (n_items + 1, 9) or not np.isfinite(rows).all():
            raise AssertionError(f"[17] {est}: {name}.txt has {len(ids)} rows "
                                 f"{ids[:2]}...{ids[-2:]}, finite {np.isfinite(rows).all()}")
        tables[name] = (ids, rows)
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rec = json.loads(f.read().strip().split("\n")[-1])
    metrics = {k: v for k, v in rec.items() if k.startswith("test/")}
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[17] {est}: logged test metrics {rec}")
    mean = dict(zip(["x_grid", "kappa", "alpha", "p_a", "p_x", "si_sdr", "sdr", "logmag",
                     "f0_error"], tables["output"][1][-1]))
    print(f"[17] {est}: proc.test scored {n_items} items in {wall:.2f} s = "
          f"{n_items / wall:.2f} items/s end to end (checkpoint load, data, forward, "
          f"scoring on the card, tables) [{card}]")
    print(f"[17] {est}: untrained weights; not comparable to r5b: mean si_sdr "
          f"{mean['si_sdr']:.3f} dB, sdr {mean['sdr']:.3f} dB, logmag {mean['logmag']:.3f}, "
          f"f0_error {mean['f0_error']:.3f} Hz; logged {metrics}")
    return tables


def dmsp_card_vs_cpu(est, model, prep, dev, gt_modes, dtype=torch.float32, phase32=False):
    """Phase 17, D.4: one batch through the model on the card and, moved
    there, on the CPU, in ``dtype``, the noise fixed to one seeded array;
    the estimator's and the blocks' outputs held at PHASE_FREE_BOUND, with
    the bank driven by the dataset's modes (``gt_modes``) or the
    estimator's.  ``phase32`` sums the phase as one float32 cumsum, as
    ``modal_synth`` did before its float64 phase sum (ops/modal.py).
    Returns the relative differences; the caller holds the waveform."""
    import copy

    from torch_fdtd_string_tpu_torch.models import synthesizer
    from torch_fdtd_string_tpu_torch.ops import modal
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    draw, phase_sum = synthesizer.uniform, modal.phase_sum
    synthesizer.uniform = lambda shape, generator, device, dtype: torch.as_tensor(
        np.random.default_rng(170).random(tuple(shape), dtype=np.float32),
        device=device).to(dtype)
    if phase32:
        modal.phase_sum = lambda freqs, dim=-2: torch.cumsum(freqs, dim=dim)
    keys = ("xg", "tg", "ka", "al", "t60")
    outs, blocks, secs = {}, {}, {}
    try:
        for where, d in (("card", dev), ("cpu", "cpu")):
            m = model if d == dev and dtype == torch.float32 else copy.deepcopy(model).to(d, dtype)
            p = {k: v.to(dtype) for k, v in S.to_device(prep, d).items()}
            step = S.make_eval_step(m, {}, [], m.inharmonic, use_gt_modes=gt_modes)
            t0 = time.perf_counter()
            outs[where] = step(p, None)[0]
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
            # freq_m and coef_m in full (the outputs keep the last frame's)
            modes = [p["f_k"], p["c_k"]] if gt_modes else [None, None]
            with torch.no_grad():
                core_in, _ = m.condition([p[k] for k in keys] + modes, p["f_0"], p["u_0"])
                blocks[where] = m.core.modulate(*core_in[:6])
    finally:
        synthesizer.uniform, modal.phase_sum = draw, phase_sum
    card, cpu = outs["card"], outs["cpu"]
    errs = {k: rel_diff(cpu[k], card[k])
            for k in ("preds_freq", "preds_coef", "preds_f0", "preds")}
    errs["freq_m"] = rel_diff(blocks["cpu"][0], blocks["card"][0])
    errs["coef_m"] = rel_diff(blocks["cpu"][1], blocks["card"][1])
    which = "the dataset's modes" if gt_modes else "the estimator's modes"
    how = f"{str(dtype)[6:]}" + (", one float32 cumsum for the phase (before the repair)"
                                 if phase32 else "")
    print(f"[17] {est}, the bank on {which}, {how}: B={prep['gt'].shape[0]} card against "
          f"CPU (same weights, noise fixed), relative to scale: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; forward {secs['card']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU")
    for k in ("preds_freq", "preds_coef", "preds_f0", "freq_m", "coef_m"):
        if not errs[k] <= PHASE_FREE_BOUND:
            raise AssertionError(f"[17] {est}: {k} {errs[k]:.3e} > {PHASE_FREE_BOUND}")
    return errs


def dmsp_profile(est, model, prep, dev, card):
    """Phase 17, D.5: the forward's stages at B=256 with CUDA events, and
    ``modal_synth`` with a float32 cumsum for its phase beside the float64
    one it ships with; each stage's share of the forward and scoring."""
    from torch_fdtd_string_tpu_torch.ops import modal
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    p = S.to_device(prep, dev)
    keys = ("xg", "tg", "ka", "al", "t60")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        cond = lambda: model.condition([p[k] for k in keys] + [None, None], p["f_0"], p["u_0"])
        core_in, _ = cond()
        hidden, mf, mc, times, alpha, omega, n = core_in
        mod = lambda: model.core.modulate(hidden, mf, mc, times, alpha, omega)
        fm, cm = mod()
        stages = {
            "estimator+features": cuda_ms(cond, reps=5),
            "FM/AM blocks": cuda_ms(mod, reps=5),
            "modal_synth": cuda_ms(lambda: model.core.harmonic(fm, cm, n), reps=5),
            "noise branch": cuda_ms(lambda: model.core.noise(hidden, cm, alpha, n, gen),
                                    reps=5),
        }
        whole = cuda_ms(lambda: model([p[k] for k in keys] + [None, None], p["f_0"],
                                      p["u_0"], gen), reps=5)
        phase_sum = modal.phase_sum
        modal.phase_sum = lambda freqs, dim=-2: torch.cumsum(freqs, dim=dim)
        try:
            synth32 = cuda_ms(lambda: model.core.harmonic(fm, cm, n), reps=5)
        finally:
            modal.phase_sum = phase_sum
    print(f"[17] {est}: forward at B={prep['gt'].shape[0]}, Nt={prep['gt'].shape[-1]} "
          f"{whole:.2f} ms (CUDA events, mean of 5); by stage " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in stages.items())
          + f"; modal_synth with a float32 cumsum for its phase {synth32:.2f} ms, with the "
          f"float64 phase sum {stages['modal_synth']:.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return stages, whole


def dmsp_scoring(est, model, prep, dev, tables, stages, card):
    """Phase 17, D.5-D.6: the first test batch as ``proc.test`` serves it
    (the estimator's modes, the device generator seeded 0), scored on the
    card as ``evaluate`` scores it and, from the same outputs, on the CPU:
    the card's rows (model and modal baseline) held to the CPU's at
    MODALS_ATOL, and the served ``modals.txt`` rows too; both scorings
    timed, with each stage's share of forward plus card scoring."""
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks.trainer import HEADER

    p = S.to_device(prep, dev)
    step = S.make_eval_step(model, {}, [], model.inharmonic, use_gt_modes=False)
    out = step(p, torch.Generator(device=dev).manual_seed(0))[0]
    n = out["preds"].shape[-1]

    def score(d):
        model_sc = S.summarize_eval_scores(prep, out["preds"].to(d), out["target"].to(d),
                                           out["preds_f0"].to(d), prep["gt_f0"], model.sr)
        modal_sc = S.summarize_eval_scores(prep, p["analytic"][..., :n].to(d),
                                           out["target"].to(d),
                                           prep.get("an_f0", prep["gt_f0"]), prep["gt_f0"],
                                           model.sr)
        return [np.array([[float(sc[k][i]) for k in HEADER] for i in range(len(prep["gt"]))])
                for sc in (model_sc, modal_sc)]

    card_rows = score(dev)
    card_ms = cuda_ms(lambda: score(dev), reps=3)
    t0 = time.perf_counter()
    cpu_rows = score("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    errs = [float(np.abs(a - b).max()) for a, b in zip(card_rows, cpu_rows)]
    B = len(prep["gt"])
    served = {name: float(np.abs(tables[name][1][:B] - rows).max())
              for name, rows in zip(("output", "modals"), card_rows)}
    stages = dict(stages, **{"scoring on the card (model + baseline)": card_ms})
    total = sum(stages.values())
    print(f"[17] {est}: scoring B={B} (model + baseline, float64) on the card "
          f"{card_ms:.2f} ms (CUDA events, mean of 3), on the CPU {cpu_ms:.2f} ms (host "
          f"clock, once); card against CPU, largest difference: model rows {errs[0]:.3e}, "
          f"baseline rows {errs[1]:.3e} (bound {MODALS_ATOL}); the served tables' first "
          f"{B} rows against the card's: output.txt {served['output']:.3e}, modals.txt "
          f"{served['modals']:.3e} [{card}]")
    print(f"[17] {est}: shares of forward + card scoring: " + ", ".join(
        f"{k} {100 * v / total:.1f}%" for k, v in stages.items()))
    for what, err in (("model rows", errs[0]), ("baseline rows", errs[1]),
                      ("modals.txt", served["modals"])):
        if not err <= MODALS_ATOL:
            raise AssertionError(f"[17] {est}: {what} off the CPU's scoring by {err:.3e}")


def f64_on_card(card):
    """Phase 17, D.7: linear-string at its own float64 on the card and with
    proc.cpu=true; the written state_u within F64_REL of scale."""
    from torch_fdtd_string_tpu_torch import run as port_run

    states, per_step = {}, {}
    for where, extra in (("card", []), ("cpu", ["proc.cpu=true"])):
        name = f"chip_smoke_17_f64_{where}"
        root_dir = os.path.join(ROOT, "results")
        shutil.rmtree(os.path.join(root_dir, name), ignore_errors=True)
        save_dir = port_run.main(F64_RUN + extra + [
            f"task.root_dir={root_dir}", f"task.save_name={name}",
            "task.randomize_name=false"])
        log = "gpu_time.txt" if where == "card" else "cpu_time.txt"
        if not os.path.exists(os.path.join(save_dir, log)):
            raise AssertionError(f"[17] float64 on the {where}: no {log}")
        with open(os.path.join(save_dir, log)) as f:
            secs = sum(float(line.split("\t")[1]) for line in f)
        z = np.load(os.path.join(save_dir, "0-0", "simulation.npz"))
        states[where] = z["state_u"]
        per_step[where] = secs / z["state_u"].shape[0] * 1e3
    su_card, su_cpu = states["card"], states["cpu"]
    if su_card.dtype != np.float64 or su_card.shape != su_cpu.shape:
        raise AssertionError(f"[17] float64 state_u {su_card.dtype} {su_card.shape}")
    err = float(np.abs(su_card - su_cpu).max() / np.abs(su_cpu).max())
    print(f"[17] linear-string at float64 (480 steps): state_u on the card against the "
          f"CPU {err:.3e} of scale (bound {F64_REL}); {per_step['card']:.2f} ms per step "
          f"on the card, {per_step['cpu']:.2f} on the CPU (simulate(), the eager engine) "
          f"[{card}]")
    if not err <= F64_REL:
        raise AssertionError(f"[17] float64 card against CPU {err:.3e}")
    return per_step


def drive_dmsp(corpus_prep, dev, card):
    """Phase 17: the DMSP serving path on phase 10's corpus, then the
    float64 repair."""
    from torch_fdtd_string_tpu_torch.data.dataset import DataLoader, Testset
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits

    load_dir, load_name = os.path.dirname(corpus_prep), os.path.basename(corpus_prep)
    items = sorted(d for d in os.listdir(corpus_prep)
                   if os.path.exists(os.path.join(corpus_prep, d, "parameters.npz")))
    n_cols = len([f for f in os.listdir(os.path.join(corpus_prep, items[0]))
                  if f.startswith("ut-")])
    counts = make_splits(corpus_prep, valid_n=DMSP_VALID, test_n=len(items) - DMSP_VALID)
    n_items = counts["test"] * n_cols
    print(f"[17] {load_name}: {len(items)} strings split {counts}: {n_items} test items "
          f"({n_cols} columns each)")
    models = dmsp_models(load_dir, load_name, dev, card)
    first = next(iter(DataLoader(Testset(load_dir, load_name), DMSP_BATCH)))
    paths = {}
    for est, (over, args, model, run_dir) in models.items():
        tables = dmsp_serve(est, over, run_dir, n_items, card)
        prep = S.prepare_batch(first, args.model.n_modes, args.model.block_size,
                               args.task.sr)
        model.eval()
        # the waveform held where the dtype resolves the phase: the served
        # path (the estimator's modes) in float32 for physics and in float64
        # for the untrained mlp, whose own modes reach ~6 rad/sample; the
        # mlp's float32 bank on the dataset's modes; printed, not held: the
        # mlp's served path in float32, and the float32 cumsum of the phase
        # that modal_synth had before its float64 phase sum
        cases = ([(False, torch.float32, False)] if est == "physics" else
                 [(True, torch.float32, False), (False, torch.float32, False),
                  (False, torch.float64, False), (True, torch.float32, True),
                  (False, torch.float32, True)])
        for gt_modes, dtype, phase32 in cases:
            errs = dmsp_card_vs_cpu(est, model, prep, dev, gt_modes, dtype, phase32)
            bound = WAVE64_BOUND if dtype == torch.float64 else WAVE_BOUND
            held = not phase32 and (est == "physics" or gt_modes or dtype == torch.float64)
            if held and not errs["preds"] <= bound:
                raise AssertionError(f"[17] {est}: ut {errs['preds']:.3e} > {bound}")
        torch.cuda.reset_peak_memory_stats()
        stages, _ = dmsp_profile(est, model, prep, dev, card)
        dmsp_scoring(est, model, prep, dev, tables, stages, card)
        paths[est] = n_items
    f64_on_card(card)
    print(f"[17] paths: proc.test (synth-dmsp, full width) scored {paths} test items per "
          f"estimator; the DMSP stack reaches no pallas_call, so no kernel of its own: "
          f"its corpus came through phase 10's bucketed launches")


def train_corpus_split(prep_dir):
    """Phase 18's split of its corpus: DMSP_TRAIN_HELD strings each to
    valid and test, the rest to train.  Returns the item counts."""
    from torch_fdtd_string_tpu_torch.tools.make_splits import make_splits

    items = sorted(d for d in os.listdir(prep_dir)
                   if os.path.exists(os.path.join(prep_dir, d, "parameters.npz")))
    n_cols = len([f for f in os.listdir(os.path.join(prep_dir, items[0]))
                  if f.startswith("ut-")])
    counts = make_splits(prep_dir, valid_n=DMSP_TRAIN_HELD, test_n=DMSP_TRAIN_HELD)
    if counts["train"] * n_cols < 3 * DMSP_TRAIN_BATCH:
        raise AssertionError(f"[18] {counts['train']} train strings x {n_cols} columns: "
                             f"fewer than 3 steps of {DMSP_TRAIN_BATCH} per epoch")
    return {k: v * n_cols for k, v in counts.items()}


def train_run(over, run_dir):
    """One ``run.main`` of phase 18; returns its wall and its metrics
    records."""
    from torch_fdtd_string_tpu_torch import run as port_run

    t0 = time.perf_counter()
    save_dir = port_run.main(over + [f"task.root_dir={os.path.dirname(run_dir)}",
                                     f"task.save_name={os.path.basename(run_dir)}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return wall, recs


def check_train_records(tag, run_dir, recs, spe, epochs, n_test, card):
    """Phase 18's checks of a run directory after ``epochs`` epochs of
    ``spe`` steps: the valid and test records (finite), profile.json's
    train_step count, BEST, the last step's checkpoint and optimizer
    state, both score tables complete and finite."""
    from torch_fdtd_string_tpu_torch.tasks import trainer

    valid = [r for r in recs if r.get("split") == "valid"]
    tests = [r for r in recs if r.get("split") == "test"]
    steps = [r["step"] for r in valid]
    if steps != [spe * (e + 1) for e in range(epochs)]:
        raise AssertionError(f"[18] {tag}: valid records at steps {steps}, not every {spe}")
    for r in valid + tests:
        bad = {k: v for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)}
        if bad:
            raise AssertionError(f"[18] {tag}: not finite in {r['split']} record: {bad}")
    if len([r for r in tests if "test/loss" in r]) != epochs:
        raise AssertionError(f"[18] {tag}: {len(tests)} test records for {epochs} epochs")
    with open(os.path.join(run_dir, "profile.json")) as f:
        prof = json.load(f)
    ckdir = trainer._ckpt_dir(run_dir)
    last = spe * epochs
    for name in ("BEST", f"step_{last}.pt", f"optstate_{last}.pt"):
        if not os.path.exists(os.path.join(ckdir, name)):
            raise AssertionError(f"[18] {tag}: no {name} in {ckdir}")
    tables = {}
    for name in ("output", "modals"):
        ids, rows = read_scores(os.path.join(run_dir, "score", f"{name}.txt"))
        want = [f"0-{i // DMSP_BATCH}-{i % DMSP_BATCH}" for i in range(n_test)] + ["# mean"]
        if ids != want or not np.isfinite(rows).all():
            raise AssertionError(f"[18] {tag}: {name}.txt has {len(ids)} rows, finite "
                                 f"{np.isfinite(rows).all()}")
        tables[name] = rows[-1]
    with open(os.path.join(ckdir, "BEST")) as f:
        best = f.read().split()
    print(f"[18] {tag}: steps {steps}, profile.json train_step {prof['train_step']}, "
          f"train_epoch mean {prof['train_epoch']['mean_s']:.2f} s; valid/loss "
          + ", ".join(f"{r['valid/loss']:.4f}" for r in valid) + "; test/loss "
          + ", ".join(f"{r['test/loss']:.4f}" for r in tests if "test/loss" in r)
          + f"; BEST step {best[0]}; lr logged {valid[-1]['lr']:.4g}; epoch walls "
          + ", ".join(f"{r['epoch_time']:.2f} s" for r in valid)
          + f"; scored {n_test} test items, mean si_sdr {tables['output'][5]:.3f} dB "
          f"(modal baseline {tables['modals'][5]:.3f} dB) [{card}]")
    return prof


def one_train_step(model, args, prep, device, dtype):
    """One train step of a copy of ``model`` in ``dtype`` on ``device``
    (synth-dmsp's optimizer and losses); returns the losses, the
    gradients and the parameters after the step, on the host, and the
    step's seconds."""
    import copy

    from torch_fdtd_string_tpu_torch.models import optim as optlib
    from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    sr = args.task.sr
    registry = build_loss_registry(sr, int(args.task.train_lens * sr))
    m = copy.deepcopy(model).to(device, dtype)
    opt, _, _ = optlib.build(m.parameters(), args.optimizer._name_, dict(args.optimizer),
                             args.scheduler._name_, dict(args.scheduler))
    step = S.make_train_step(m, opt, registry, list(args.task.loss_criteria), m.inharmonic)
    p = {k: v.to(dtype) for k, v in S.to_device(prep, device).items()}
    t0 = time.perf_counter()
    _, losses = step(S.TrainState(m, opt, 0, torch.Generator(device=device)), p)
    losses = {k: float(v) for k, v in losses.items()}
    secs = time.perf_counter() - t0
    grads = {k: (q.grad if q.grad is not None else torch.zeros_like(q)).detach().double().cpu()
             for k, q in m.named_parameters()}
    params = {k: q.detach().double().cpu() for k, q in m.named_parameters()}
    return losses, grads, params, secs


def train_step_card_vs_cpu(est, args, prep, dev, card):
    """Phase 18: one train step of the full-width model from the same
    weights (seed 18) on the same batch of DMSP_TRAIN_BATCH, on the card
    and on the CPU, the noise fixed to one seeded array.  float64: each
    loss within LOSS64 (relative, with a floor of 1e-3 of the summed
    loss), every parameter's gradient within GRAD64 of its tensor's scale,
    the parameters after the step within PARAM64.  float32: each loss
    within LOSS32, the whole gradient within GRAD32 of its scale, and the
    card's float32 gradient no further from the card's float64 one than
    F32_RATIO times the CPU's distance, plus 1e-3.  Then
    ``gradient_precision`` on the card."""
    from torch_fdtd_string_tpu_torch.models import synthesizer
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    model = S.build_model(args, torch.Generator().manual_seed(18))
    draw = synthesizer.uniform
    synthesizer.uniform = lambda shape, generator, device, dtype: torch.as_tensor(
        np.random.default_rng(180).random(tuple(shape), dtype=np.float32),
        device=device).to(dtype)
    runs = {}
    try:
        for dtype in (torch.float64, torch.float32):
            for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
                runs[where, dtype] = one_train_step(model, args, prep, d, dtype)
        precision = gradient_precision(model, args, prep, dev)
    finally:
        synthesizer.uniform = draw

    def loss_err(a, b):
        # relative to each loss, with a floor of 1e-3 of the summed loss:
        # the physics estimator meets the dataset's modes, and its modeamps
        # and modefreq losses are ~1e-10
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-3 * abs(b["loss"])) for k in b)

    f64, f32 = torch.float64, torch.float32
    (l64c, g64c, p64c, s64c), (l64h, g64h, p64h, s64h) = runs["card", f64], runs["cpu", f64]
    (l32c, g32c, p32c, s32c), (l32h, g32h, p32h, s32h) = runs["card", f32], runs["cpu", f32]
    errs = {
        "loss64": loss_err(l64c, l64h),
        "grad64": max(rel_diff(g64h[k], g64c[k]) for k in g64h),
        "param64": max(rel_diff(p64h[k], p64c[k]) for k in p64h),
        "loss32": loss_err(l32c, l32h),
        "grad32": rel_diff(flat(g32h), flat(g32c)),
        "param32": max(rel_diff(p32h[k], p32c[k]) for k in p32h),
        "card32_to_64": rel_diff(flat(g64c), flat(g32c)),
        "cpu32_to_64": rel_diff(flat(g64h), flat(g32h)),
    }
    worst = sorted(((rel_diff(g64c[k], g32c[k]), k) for k in g64c), reverse=True)[:3]
    print(f"[18] {est}: one train step at B={prep['gt'].shape[0]}, card against CPU (same "
          f"weights, noise fixed), relative to scale: float64 losses {errs['loss64']:.2e} "
          f"(bound {LOSS64}), gradients {errs['grad64']:.2e} per tensor (bound {GRAD64}), "
          f"parameters after the step {errs['param64']:.2e} (bound {PARAM64}); float32 "
          f"losses {errs['loss32']:.2e} (bound {LOSS32}), whole gradient {errs['grad32']:.3e} "
          f"(bound {GRAD32}), parameters after the step {errs['param32']:.2e} (not held); "
          f"the float32 gradient against the float64 one: card {errs['card32_to_64']:.3e}, "
          f"CPU {errs['cpu32_to_64']:.3e} (card within {F32_RATIO}x the CPU's + 1e-3), worst "
          "tensors on the card " + ", ".join(f"{k} {v:.2e}" for v, k in worst)
          + f"; step float32 {s32c:.2f} s card (first call) / {s32h:.2f} s CPU, float64 "
          f"{s64c:.2f} / {s64h:.2f} s [{card}]")
    print(f"[18] {est}: the float32 gradient's distance from float64 on the card at "
          f"B={prep['gt'].shape[0]}, by criterion: "
          + ", ".join(f"{k} {v:.3e}" for k, v in precision["by_criterion"].items())
          + f"; all criteria {precision['f32']:.3e}, with modal_synth in float64 "
          f"{precision['modal64']:.3e}; float64 with the FM frequencies rounded to float32 "
          f"values moves the float64 gradient by {precision['freq_rounded']:.3e}; the FM "
          f"frequencies in float32 are {precision['freq_rel']:.2e} (relative, per element) "
          f"off float64, the phase at the item's end {precision['phase_rad']:.2e} rad; items "
          f"whose mean square is below float32's eps (l1's floor): output "
          f"{precision['quiet'][0]}, target {precision['quiet'][1]}; float64 with l1's floor at "
          f"float32's eps moves the float64 gradient by {precision['l1_floor32']:.3e}; float32 "
          f"with l1's floor at float64's eps is {precision['f32_l1_floor64']:.3e} off float64 "
          f"[{card}]")
    for key, bound in (("loss64", LOSS64), ("grad64", GRAD64), ("param64", PARAM64),
                       ("loss32", LOSS32), ("grad32", GRAD32)):
        if not errs[key] <= bound:
            raise AssertionError(f"[18] {est}: {key} card vs CPU {errs[key]:.3e} > {bound}")
    if not errs["card32_to_64"] <= F32_RATIO * errs["cpu32_to_64"] + 1e-3:
        raise AssertionError(f"[18] {est}: the card's float32 gradient is "
                             f"{errs['card32_to_64']:.3e} off float64, the CPU's "
                             f"{errs['cpu32_to_64']:.3e}")


def flat(tensors):
    """A dict of tensors as one flat float64 tensor, in the dict's order."""
    return torch.cat([v.detach().double().cpu().flatten() for v in tensors.values()])


def gradient_precision(model, args, prep, dev):
    """Phase 18: where the float32 gradient's distance from float64 comes
    from, on the card at the main path's batch (the caller fixes the
    noise).  Each criterion's gradient in float32 against float64; all
    criteria with ``modal_synth`` (the phase sum, its backward, the cosine
    bank) in float64 inside a float32 model; the float64 gradient with the
    FM block's frequencies rounded to float32 values (one rounding of the
    same point); how far the FM frequencies and the phase they integrate
    to over the item drift in float32."""
    import copy

    from torch_fdtd_string_tpu_torch.models import synthesizer
    from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    registry = build_loss_registry(args.task.sr, int(args.task.train_lens * args.task.sr))
    criteria = list(args.task.loss_criteria)
    modal_synth, modulate = synthesizer.modal_synth, synthesizer.DMSPCore.modulate
    freqs, power = {}, {}

    def modal64(f, c, d):
        return modal_synth(f.double(), c.double(), d.double()).to(f.dtype)

    def l1_floored(preds, target, eps):
        # losses.l1_loss with its floor on the mean square at ``eps`` in
        # place of finfo(dtype).eps
        eps = preds.new_tensor(eps)
        rms = [torch.sqrt(torch.maximum(torch.mean(x**2, -1, keepdim=True), eps))
               for x in (preds, target)]
        return torch.mean(torch.abs(preds / rms[0] - target / rms[1]))

    def grad(dtype, crit, f64_modal=False, round_freq=False, l1_eps=None):
        reg = dict(registry)
        if l1_eps is not None:
            reg["l1"] = (lambda a, b: l1_floored(a, b, l1_eps), registry["l1"][1])

        def modulated(self, *a):
            f, c = modulate(self, *a)
            if round_freq:
                f = f + (f.float().double() - f).detach()
            freqs[dtype] = f.detach().double()
            return f, c

        m = copy.deepcopy(model).to(dev, dtype)
        p = {k: v.to(dtype) for k, v in S.to_device(prep, dev).items()}
        synthesizer.DMSPCore.modulate = modulated
        synthesizer.modal_synth = modal64 if f64_modal else modal_synth
        try:
            out = S.forward_outputs(m, p, None, m.inharmonic)
            if dtype == torch.float64:
                power[dtype] = torch.mean(out["preds"].detach() ** 2, -1)
            loss = S.compute_losses(out, reg, crit)[0]
            if loss.requires_grad:  # not the physics estimator's own mode losses
                loss.backward()
        finally:
            synthesizer.DMSPCore.modulate, synthesizer.modal_synth = modulate, modal_synth
        return flat({k: q.grad if q.grad is not None else torch.zeros_like(q)
                     for k, q in m.named_parameters()})

    f64, f32 = torch.float64, torch.float32
    by_criterion = {}
    for c in criteria:
        g = grad(f64, [c])
        if g.abs().max() > 0:
            by_criterion[c] = rel_diff(g, grad(f32, [c]))
    ref = grad(f64, criteria)
    g32 = grad(f32, criteria)
    drift = freqs[f32] - freqs[f64]  # (b, frames, modes) rad/sample
    eps32, eps64 = torch.finfo(f32).eps, torch.finfo(f64).eps
    target_power = torch.mean(torch.as_tensor(prep["gt"], dtype=f64) ** 2, -1)
    return {
        # l1_loss floors each item's mean square at finfo(dtype).eps
        "quiet": (int((power[f64] < eps32).sum()), int((target_power < eps32).sum())),
        "l1_floor32": rel_diff(ref, grad(f64, criteria, l1_eps=eps32)),
        "f32_l1_floor64": rel_diff(ref, grad(f32, criteria, l1_eps=eps64)),
        "by_criterion": by_criterion,
        "f32": rel_diff(ref, g32),
        "modal64": rel_diff(ref, grad(f32, criteria, f64_modal=True)),
        "freq_rounded": rel_diff(ref, grad(f64, criteria, round_freq=True)),
        "freq_rel": float((drift.abs() / freqs[f64].abs().clamp_min(1e-30)).max()),
        # the phase sums the frequencies upsampled to the sample rate
        "phase_rad": float((drift.sum(1) * args.model.block_size).abs().max()),
    }
def train_step_timing(args, prep, dev, card, forms="fixed-order forms"):
    """Phase 18: the train step at B=DMSP_TRAIN_BATCH on the card, CUDA
    events, mean of 5 after a warm-up, whole and split into the forward
    (with the losses), the backward and the optimizer; peak device
    memory.  ``forms`` names the ops in use (:func:`use_forms`)."""
    from torch_fdtd_string_tpu_torch.models import optim as optlib
    from torch_fdtd_string_tpu_torch.models.losses import build_loss_registry
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    sr = args.task.sr
    registry = build_loss_registry(sr, int(args.task.train_lens * sr))
    criteria = list(args.task.loss_criteria)
    model = S.build_model(args, torch.Generator().manual_seed(18), dev)
    opt, _, _ = optlib.build(model.parameters(), args.optimizer._name_, dict(args.optimizer),
                             args.scheduler._name_, dict(args.scheduler))
    state = S.TrainState(model, opt, 0, torch.Generator(device=dev).manual_seed(0))
    step = S.make_train_step(model, opt, registry, criteria, model.inharmonic)
    p = S.to_device(prep, dev)

    def forward():
        out = S.forward_outputs(model, p, state.generator, model.inharmonic)
        return S.compute_losses(out, registry, criteria)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    whole = cuda_ms(lambda: step(state, p), reps=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd = cuda_ms(forward, reps=5)
    split = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = forward()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(split, zip(ev, ev[1:])):
            split[k].append(a.elapsed_time(b))
    split = {k: float(np.mean(v[1:])) for k, v in split.items()}  # the first warms up
    B = prep["gt"].shape[0]
    print(f"[18] train step at B={B}, Nt={prep['gt'].shape[-1]} (physics, synth-dmsp's "
          f"widths, radam; {forms}): {whole:.2f} ms (CUDA events, mean of 5) = {B / whole * 1e3:.1f} "
          f"train items/s; forward with the losses {split['forward']:.2f} ms "
          f"(alone {fwd:.2f}), backward {split['backward']:.2f} ms, optimizer "
          f"{split['optimizer']:.2f} ms (mean of 5 after one); peak device memory {peak:.2f} "
          f"GiB [{card}]")
    return whole, split, peak


def parent_forms():
    """The four ops of the train step as the parent commit wrote them, before
    their fixed-order forms (``upsample`` by ``F.interpolate``, the running
    sums by ``torch.cumsum``, the STFT's reflect padding by ``F.pad``), to
    be swapped in by :func:`use_forms` for the before-and-after timing.
    The physics estimator's ``take_along`` has no backward in the step
    (the estimator has no learned parameters) and stays."""
    import torch.nn.functional as F

    def interpolate(signal, factor):
        return F.interpolate(signal.transpose(1, 2), scale_factor=factor, mode="linear",
                             align_corners=False).transpose(1, 2)

    def cumsum(x, dim=-2, block=None):
        return torch.cumsum(x, dim)

    def reflect(x, pad):
        return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]

    return interpolate, cumsum, cumsum, reflect


def use_forms(forms=None):
    """Swap ``forms`` (:func:`parent_forms`) into the port's modules;
    returns the forms they held.  None leaves them as they are."""
    from torch_fdtd_string_tpu_torch.models import blocks, losses, synthesizer
    from torch_fdtd_string_tpu_torch.ops import modal

    held = (synthesizer.upsample, modal.running_sum, blocks.running_sum, losses.reflect_pad)
    if forms is not None:
        (synthesizer.upsample, modal.running_sum, blocks.running_sum,
         losses.reflect_pad) = forms
    return held


def deterministic_step(job):
    """``--deterministic-step``: one float32 train step (``trainer.
    build_training``) on the saved batch under
    ``torch.use_deterministic_algorithms(True)``, which raises at any op
    with no deterministic CUDA form and warns at none."""
    import warnings

    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    with np.load(job["prep"]) as z:
        prep = S.to_device({k: z[k] for k in z.files}, dev)
    setup = trainer.build_training(compose(port_run.CONFIG_DIR, job["over"]), dev, 100,
                                   sharded=False)
    state = trainer.train_state(setup.model, setup.optimizer, 0, 0, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = setup.train_step(state, prep)[1]
        torch.cuda.synchronize()
    alerts = [str(w.message) for w in caught if "determinis" in str(w.message)]
    if alerts or not all(np.isfinite(float(v)) for v in losses.values()):
        raise AssertionError(f"deterministic step: {alerts}, losses {losses}")
    print(json.dumps({"loss": float(losses["loss"])}))
    return 0


def check_determinism(args, over, prep, dev, card):
    """Phase 18: the train step at the main path's batch (a) under
    ``torch.use_deterministic_algorithms(True)`` in a child process (cuBLAS
    asks for ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` there), nothing raised,
    for both estimators; (b) two float32 runs of two steps each, from the
    same seed on the same two batches and noise generator: every loss and
    every parameter equal bit for bit."""
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S

    path = os.path.join(ROOT, "results", "chip_smoke_18_batch.npz")
    np.savez(path, **prep)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    batches = [S.to_device(prep, dev), S.to_device(
        {k: v[::-1].copy() for k, v in prep.items()}, dev)]
    # both children at once, beside this process's runs
    children = {}
    for est in ("physics", "mlp"):
        log = open(os.path.join(ROOT, "results", f"chip_smoke_18_deterministic_{est}.log"),
                   "w+")
        children[est] = (time.perf_counter(), log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--deterministic-step", json.dumps(
                {"prep": path, "over": over + [f"model.mode_estimator={est}"]})],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for est in ("physics", "mlp"):
            check_deterministic_pair(est, over, batches, children[est], prep, dev, card)
    finally:
        for _, log, proc in children.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()


def check_deterministic_pair(est, over, batches, child, prep, dev, card):
    """Phase 18 for one estimator: the child's step under deterministic
    algorithms (``child``: its start time, log and process) and two float32
    runs of two steps in this process, bit for bit."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    est_over = over + [f"model.mode_estimator={est}"]
    runs = []
    for _ in range(2):
        setup = trainer.build_training(compose(port_run.CONFIG_DIR, est_over), dev, 100,
                                       sharded=False)
        state = trainer.train_state(setup.model, setup.optimizer, 0, 0, dev)
        losses = [setup.train_step(state, b)[1] for b in batches]
        runs.append(([{k: float(v) for k, v in ld.items()} for ld in losses],
                     {k: q.detach().clone() for k, q in setup.model.named_parameters()}))
    t0, log, proc = child
    try:
        code = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        code = "none within 600 s"
    log.seek(0)
    text = log.read()
    if code != 0:
        raise AssertionError(f"[18] {est}: the step under deterministic algorithms "
                             f"failed (exit {code}):\n{text[-6000:]}")
    child_loss = next(json.loads(line)["loss"] for line in reversed(text.splitlines())
                      if line.startswith('{"loss"'))
    (l1, p1), (l2, p2) = runs
    same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    diff = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
    print(f"[18] {est}: the float32 step at B={prep['gt'].shape[0]} under "
          f"torch.use_deterministic_algorithms(True) (child process, "
          f"CUBLAS_WORKSPACE_CONFIG=:4096:8): nothing raised or warned, loss "
          f"{child_loss:.6f}, {time.perf_counter() - t0:.2f} s with start-up (both "
          f"children at once, beside these runs); two runs "
          f"of two float32 steps (same seed, batches, noise): losses and all "
          f"{len(p1)} parameters bit for bit {same} (largest difference {diff:.3e}); "
          f"(the child's first loss, under its own cuBLAS workspace, "
          f"{'equals' if child_loss == l1[0]['loss'] else 'differs from'} theirs) [{card}]")
    if not same:
        raise AssertionError(f"[18] {est}: two float32 runs differ ({diff:.3e})")


def check_repeated_epoch(over, card):
    """Phase 18: ``proc.train`` for one epoch on one card twice through
    ``run.main`` (``proc.test=false``): the valid records' losses and the
    checkpoint's parameters equal bit for bit."""
    from torch_fdtd_string_tpu_torch.tasks import trainer

    epoch = over + ["task.total_epoch=1", "proc.test=false"]
    out = []
    for n in (1, 2):
        run_dir = os.path.join(ROOT, "results", f"chip_smoke_18_epoch{n}")
        shutil.rmtree(run_dir, ignore_errors=True)
        wall, recs = train_run(epoch, run_dir)
        valid = [r for r in recs if r.get("split") == "valid"]
        ckpt = trainer.latest_checkpoint(run_dir)
        params = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
        out.append((wall, valid, params))
    (w1, v1, p1), (w2, v2, p2) = out
    keys = sorted(k for k in v1[0] if k.startswith("valid/"))
    same = (len(v1) == len(v2) == 1 and all(v1[0][k] == v2[0][k] for k in keys)
            and all(torch.equal(p1[k], p2[k]) for k in p1))
    print(f"[18] proc.train one epoch on one card, twice: valid/loss {v1[0]['valid/loss']!r} "
          f"and {v2[0]['valid/loss']!r}; every valid loss and all {len(p1)} checkpoint "
          f"tensors bit for bit {same}; walls {w1:.2f} / {w2:.2f} s [{card}]")
    if not same:
        raise AssertionError(f"[18] the one-card epoch does not repeat: {v1} {v2}")


def drive_dmsp_train(dev, card):
    """Phase 18: DMSP training at synth-dmsp's full width (physics, batch
    128, radam under noam) on a fresh corpus of phase 10's recipe."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.data.dataset import DataLoader, Trainset
    from torch_fdtd_string_tpu_torch.models import optim as optlib
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    corpus = drive_fused(18, "corpus recipe B=48, two batches (seed 1818)", TRAIN_CORPUS,
                         PREP_KEYS_CORPUS, 8, card)
    prep_dir = corpus["save_dir"] + "-prep"
    load_dir, load_name = os.path.dirname(prep_dir), os.path.basename(prep_dir)
    n = train_corpus_split(prep_dir)
    spe = n["train"] // DMSP_TRAIN_BATCH
    over = DMSP_TRAIN + [f"task.load_dir={load_dir}", f"task.load_name={load_name}"]
    args = compose(port_run.CONFIG_DIR, over)
    if (args.task.batch_size, args.model.hidden_dim, args.model.n_modes) != (
            DMSP_TRAIN_BATCH, 512, 40):
        raise AssertionError(f"[18] not synth-dmsp's full width: {args.task.batch_size}, "
                             f"{args.model.hidden_dim}, {args.model.n_modes}")
    print(f"[18] {load_name}: items {n}: {spe} steps of {DMSP_TRAIN_BATCH} per epoch")
    run_dir = os.path.join(ROOT, "results", "chip_smoke_18_train")
    shutil.rmtree(run_dir, ignore_errors=True)

    caches = []
    device_cache = trainer._device_cache

    def logged_cache(*a, **kw):
        gather, n_items = device_cache(*a, **kw)
        caches.append((n_items, gather.nbytes, gather.seconds))
        return gather, n_items

    trainer._device_cache = logged_cache
    try:
        wall1, recs = train_run(over + ["task.total_epoch=2"], run_dir)
    finally:
        trainer._device_cache = device_cache
    check_train_records("run 1 (2 epochs)", run_dir, recs, spe, 2, n["test"], card)
    print(f"[18] run 1: proc.train + proc.test wall {wall1:.2f} s; device cache "
          f"{'used' if caches else 'NOT used'}: " + ", ".join(
              f"{k} items {b / 1e6:.1f} MB in {s:.2f} s" for k, b, s in caches)
          + f"; {2 * spe * DMSP_TRAIN_BATCH / wall1:.1f} train items/s over the whole run "
          f"[{card}]")
    if len(caches) != 3:
        raise AssertionError(f"[18] the device cache was not used: {caches}")

    # run 2: resume for a third epoch; the optimizer state loaded equals
    # the saved one bit for bit, the count goes on from the step
    restored = {}
    restore = trainer.restore

    def checked_restore(save_dir, model, optimizer):
        step = restore(save_dir, model, optimizer)
        saved = torch.load(os.path.join(trainer._ckpt_dir(save_dir), f"optstate_{step}.pt"),
                           map_location="cpu", weights_only=True)
        got = optimizer.state_dict()
        same = got["param_groups"] == saved["param_groups"] and all(
            torch.equal(got["state"][i][k].cpu(), v)
            for i, s in saved["state"].items() for k, v in s.items())
        restored.update(step=step, same=same, count=optimizer.count, lr=optimizer.lr())
        return step

    trainer.restore = checked_restore
    try:
        wall2, recs = train_run(over + ["task.total_epoch=3", "task.resume=true"], run_dir)
    finally:
        trainer.restore = restore
    schedule = optlib.get_schedule(args.scheduler._name_, args.optimizer.lr,
                                   dict(args.scheduler))
    print(f"[18] run 2 (resume, 3 epochs): wall {wall2:.2f} s; restored step "
          f"{restored.get('step')}, optimizer state equal to the saved bit for bit "
          f"{restored.get('same')}, count {restored.get('count')}, first lr "
          f"{restored.get('lr')} = schedule({restored.get('step')}) "
          f"{schedule(restored.get('step', -1))}")
    if not (restored.get("step") == 2 * spe and restored["same"]
            and restored["count"] == 2 * spe and restored["lr"] == schedule(2 * spe)):
        raise AssertionError(f"[18] resume: {restored}")
    check_train_records("run 2 (resumed)", run_dir, recs, spe, 3, n["test"], card)

    first = next(iter(DataLoader(Trainset(load_dir, load_name), DMSP_TRAIN_BATCH)))
    prep = S.prepare_batch(first, args.model.n_modes, args.model.block_size, args.task.sr)
    prep.pop("analytic")
    for est in ("mlp", "physics"):
        est_args = compose(port_run.CONFIG_DIR, over + [f"model.mode_estimator={est}"])
        train_step_card_vs_cpu(est, est_args, prep, dev, card)
    check_determinism(args, over, prep, dev, card)
    check_repeated_epoch(over, card)
    # the step before and after the fixed-order forms, in turns on one card
    times = {}
    for tag in ("parent forms", "fixed-order forms", "fixed-order forms", "parent forms"):
        held = use_forms(parent_forms() if tag == "parent forms" else None)
        try:
            whole, split, peak = train_step_timing(args, prep, dev, card, tag)
        finally:
            use_forms(held)
        times.setdefault(tag, []).append(whole)
    print("[18] train step at B=128, ms (CUDA events, mean of 5; in turns parent, fixed, "
          "fixed, parent): " + "; ".join(f"{k} {', '.join(f'{t:.2f}' for t in v)}"
                                        for k, v in times.items()) + f" [{card}]")
    print(f"[18] paths: proc.train (synth-dmsp, full width, physics, batch "
          f"{DMSP_TRAIN_BATCH}) {3 * spe} steps over two runs, resumed once; the training "
          f"path reaches no pallas_call, so no kernel of its own")
    return dict(step_ms=whole, split=split, peak=peak, over=over)


def synthetic_recording(path, length=1.0, seed=19):
    """``path/input.wav`` (tests/test_torch_presets.py's recording): a tone
    gliding linearly from 196 to 233 Hz, its envelope restarted (decaying
    at 8 /s) at 0, 1/3 and 2/3 of the length, with -60 dB of seeded noise."""
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    n = int(length * SR)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(196.0 + 37.0 * t / length) / SR
    env = np.zeros(n)
    for on in (0.0, length / 3, 2 * length / 3):
        i = int(on * SR)
        env[i:] = np.exp(-8.0 * np.arange(n - i) / SR)
    x = 0.5 * env * np.sin(phase) + 1e-3 * np.random.default_rng(seed).standard_normal(n)
    os.makedirs(path, exist_ok=True)
    wavio.write(os.path.join(path, "input.wav"), x, SR, "PCM_24")


def read_columns(d, prefix, cols):
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    return np.stack([wavio.read(os.path.join(d, f"{prefix}-{x}.wav"))[0] for x in cols],
                    axis=1)


def check_bank(item_dir, dev, card):
    """One prepared item's modal bank again from its ``parameters.npz``:
    ``modal_synth_nyquist`` on the card (CUDA events) against its numpy
    twin on the host at BANK_NP_BOUND of scale, and against the item's
    written ``ua`` wavs (PCM_24).  Returns the two times in ms."""
    from torch_fdtd_string_tpu_torch.ops import modal
    from torch_fdtd_string_tpu_torch.tasks import process_training_data as ptd

    z = np.load(os.path.join(item_dir, "parameters.npz"))
    f0, kappa = np.asarray(z["f0"], np.float64), float(z["kappa"])
    omega = f0 / SR * (2 * np.pi)
    freq_tv = z["mode_freq"][None, :] + (omega - omega[0])[:, None]
    sig0_tv, _ = ptd.t60_to_sigma_tv(z["T60"], f0, 2 * f0 * kappa)
    damp = np.exp(-z["t"][:, 0] * sig0_tv)
    amps = np.asarray(z["mode_amps"].T, np.float32)  # (Nx, n)
    args = (torch.as_tensor(freq_tv[None], dtype=torch.float64, device=dev),
            torch.as_tensor(amps[:, None, :], device=dev),
            torch.as_tensor(damp[None, :, None], dtype=torch.float32, device=dev), float(SR))
    got = modal.modal_synth_nyquist(*args)[:, :, 0].T.cpu().numpy()
    bank_ms = cuda_ms(lambda: modal.modal_synth_nyquist(*args), reps=5)
    # its stages alone: the float64 running sum, the masked cosines, the product
    freq = args[0][0]
    phase = modal.phase_sum(freq)
    tbank = torch.cos(phase).float()
    stages = dict(phase_sum=cuda_ms(lambda: modal.phase_sum(freq), reps=5),
                  cos=cuda_ms(lambda: torch.cos(phase).float(), reps=5),
                  product=cuda_ms(lambda: tbank @ args[1][:, 0, :].T, reps=5))
    t0 = time.perf_counter()
    ref = modal.modal_synth_nyquist_np(freq_tv, amps, damp, SR)
    host_ms = (time.perf_counter() - t0) * 1e3
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    cols = range(0, amps.shape[0], 16)
    written = read_columns(item_dir, "ua", cols)
    werr = float(np.abs(written - got[:, list(cols)]).max())
    print(f"[19] modal bank of {os.path.basename(item_dir)} ({freq_tv.shape[0]} steps, "
          f"{amps.shape[1]} modes, {amps.shape[0]} columns): card {bank_ms:.3f} ms (CUDA "
          f"events; {', '.join(f'{k} {v:.3f}' for k, v in stages.items())} ms alone), "
          f"numpy twin on the host {host_ms:.1f} ms; card against twin "
          f"{err:.3e} of scale {scale:.3e} ({err / scale:.2e}); against the written ua "
          f"wavs {werr:.3e} [{card}]")
    if not err <= BANK_NP_BOUND * scale:
        raise AssertionError(f"[19] the card's modal bank is {err / scale:.2e} of scale "
                             f"off its numpy twin")
    if not werr <= 2.0 / 8388607:
        raise AssertionError(f"[19] the written ua is {werr} off the card's bank")
    return bank_ms, host_ms


def check_classic_against_fused(classic_run, prep, fused_prep, card):
    """Phase 19 (a)'s items against phase 9's fused prep of the same draws:
    first the two runs' readouts (phase 4's ``simulation.npz`` against the
    fused items' ``uout``), then the items at the JAX bounds
    (tests/test_pipeline.py:247-327): ``x`` equal, ``mode_freq`` rtol 1e-6,
    ``mode_amps`` rtol 1e-4, ``ut`` within 5e-4 of the peak (the fused pull's
    float16) on every 4th column."""
    items = sorted(os.listdir(prep))
    fused = sorted(d for d in os.listdir(fused_prep)
                   if os.path.isdir(os.path.join(fused_prep, d)))
    if items != fused:
        raise AssertionError(f"[19] classic items {items} against fused {fused}")
    cols = range(0, 256, 4)
    worst = dict(uout=0.0, mode_freq=0.0, mode_amps=0.0, ut=0.0)
    for d in items:
        u_c = np.load(os.path.join(classic_run, d, "simulation.npz"))["uout"]
        fz = np.load(os.path.join(fused_prep, d, "parameters.npz"))
        cz = np.load(os.path.join(prep, d, "parameters.npz"))
        diff = np.abs(u_c.astype(np.float64) - fz["uout"])
        if diff.max() > 0:
            at = int(np.argmax(diff > 0))
            print(f"[19] item {d}: the classic and the fused readouts part at step "
                  f"{at + 2}, max {diff.max():.3e} of scale {np.abs(u_c).max():.3e}")
            if not diff.max() <= READOUT_REL * np.abs(u_c).max():
                raise AssertionError(f"[19] item {d}: uout beyond the phase-3 bound")
        worst["uout"] = max(worst["uout"], float(diff.max()))
        if not np.array_equal(fz["x"], cz["x"]):
            raise AssertionError(f"[19] item {d}: x differs")
        rf = float(np.abs(fz["mode_freq"] / cz["mode_freq"] - 1).max())
        ra = np.abs(fz["mode_amps"] - cz["mode_amps"]) - 1e-4 * np.abs(cz["mode_amps"])
        wf = read_columns(os.path.join(fused_prep, d), "ut", cols)
        wc = read_columns(os.path.join(prep, d), "ut", cols)
        peak = float(np.abs(wc).max())
        ut = float(np.abs(wf - wc).max()) / peak
        worst.update(mode_freq=max(worst["mode_freq"], rf),
                     mode_amps=max(worst["mode_amps"], float(ra.max())),
                     ut=max(worst["ut"], ut))
        if rf > 1e-6 or ra.max() > 1e-8 or not ut * peak < 5e-4 * peak + 1e-7:
            raise AssertionError(f"[19] item {d}: mode_freq {rf:.2e}, mode_amps "
                                 f"{ra.max():.2e} past rtol, ut {ut:.2e} of the peak")
    print(f"[19] {len(items)} classic items against phase 9's fused items: uout max abs "
          f"diff {worst['uout']:.3e}, mode_freq {worst['mode_freq']:.2e} relative, "
          f"mode_amps {worst['mode_amps']:.2e} past rtol 1e-4, ut {worst['ut']:.2e} of "
          f"the peak [{card}]")


def check_scores(run_dir, n_items, card):
    """Phase 19 (b): ``evaluation.txt`` and ``summary.txt`` of a run."""
    with open(os.path.join(run_dir, "evaluation.txt")) as f:
        header = f.readline().rstrip("\n").split("\t")[1:]
        rows = {p[0]: np.array([float(v) for v in p[1:]])
                for p in (line.rstrip("\n").split("\t") for line in f)}
    if len(rows) != n_items or not all(np.isfinite(v).all() for v in rows.values()):
        raise AssertionError(f"[19] evaluation.txt: {len(rows)} rows of {n_items}, or "
                             f"not finite")
    col = {k: i for i, k in enumerate(header)}
    diff = {n: r[col["abs_diff_modes"]] / r[col["f0_mode_pred"]] for n, r in rows.items()}
    print(f"[19] evaluation.txt: {len(rows)} rows; |f0 estimate - first mode| / first mode "
          f"max {max(diff.values()):.4f}, median {np.median(list(diff.values())):.4f} "
          f"(bound 0.05)")
    bad = {n: round(v, 4) for n, v in diff.items() if not v < 0.05}
    if bad:
        raise AssertionError(f"[19] items off their first mode: {bad}")
    with open(os.path.join(run_dir, "summary.txt")) as f:
        lines = f.read().splitlines()
    if [ln.split("\t")[0] for ln in lines] != ["stat", "mean", "median", "std"] or \
            lines[0].split("\t")[1:] != header:
        raise AssertionError(f"[19] summary.txt: {lines[:1]}")


def drive_presets(dev, card):
    """Phase 19 (c): presets of a synthetic recording drive a bowed and a
    hammered batch of 4 through ``task.load_config``.  Returns the kernel
    launches by specialization and the walls."""
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        string_chunked_bucketed,
        string_chunked_bucketed_reference,
    )
    from torch_fdtd_string_tpu_torch.tasks import preprocess_data, simulate
    from torch_fdtd_string_tpu_torch.utils import wav as wavio
    from torch_fdtd_string_tpu_torch.utils.frequency import compute_harmonic_parameters

    root = os.path.join(ROOT, "results", "chip_smoke_19_presets")
    shutil.rmtree(root, ignore_errors=True)
    synthetic_recording(os.path.join(root, "rec"))
    t0 = time.perf_counter()
    f0, force, strikes = preprocess_data.process(root, "rec", plot=False)
    pre_s = time.perf_counter() - t0
    print(f"[19] preprocess_data: {pre_s:.2f} s for 1 s of audio; f0 {f0.min():.2f}-"
          f"{f0.max():.2f} Hz, bow force on {(force > 0).mean():.3f} of the samples, "
          f"strikes at samples {np.nonzero(strikes)[0].tolist()} [{card}]")
    preset = os.path.join(root, "rec")
    launches, walls = {}, {}
    for exc, extra in (("bow", []), ("hammer", ["task.skip_silence=false"])):
        over = PRESETS + [f"model.excitation={exc}", f"task.load_config={preset}"] + extra
        n, run = drive(19, f"task.load_config, model.excitation={exc}", over, exc, card)
        launches[exc], walls[exc] = n, run["wall"]
        for d in run["items"]:
            st = np.load(os.path.join(run["save_dir"], d, "string_params.npz"))
            if not np.array_equal(st["target_f0"], f0[:SR].astype(np.float32)):
                raise AssertionError(f"[19] {exc} {d}: target_f0 is not the preset")
            wav, _ = wavio.read(os.path.join(run["save_dir"], d, "output-u.wav"))
            if exc == "hammer":
                # the string step reads the hammer's first two displacement
                # rows only: the recording's strikes come later, so the
                # hammer stays at rest (both packages)
                if np.abs(wav).max() != 0:
                    raise AssertionError(f"[19] hammer {d}: not silent")
                continue
            track = compute_harmonic_parameters(np.asarray(wav, np.float64), SR)
            sel = (track["f0"] > 0) & (track["time"] >= 0.1)
            want = f0[np.minimum((track["time"][sel] * SR).astype(int), SR - 1)]
            dev_rel = np.abs(track["f0"][sel] / want - 1)
            print(f"[19] bow {d}: output f0 track against the preset over {int(sel.sum())} "
                  f"voiced frames: median {np.median(dev_rel):.4f}, 90th percentile "
                  f"{np.quantile(dev_rel, 0.9):.4f} (bound {PRESET_F0_REL} on the median)")
            if not (sel.sum() > 0 and np.median(dev_rel) <= PRESET_F0_REL):
                raise AssertionError(f"[19] bow {d}: output f0 off the preset")
        if exc == "hammer":
            print(f"[19] hammer: every item silent, as the JAX package runs this preset")
        # the preset batch's launch against its plain version over 256 steps
        task, (string, bow, hammer, bm, hm), consts = nsynth_draw(over)
        simulate._load_presets(preset, int(task.length * SR), string, bow, hammer, 1.0 / SR)
        args, kwargs = truncate(simulate.kernel_inputs(
            string, consts, int(task.length * SR), dev, bow, hammer, bm, hm), 256)
        hb = host_bounds(args)
        got = string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
        ref = string_chunked_bucketed_reference(*args, host_bounds=hb, **kwargs)
        compare(f"[19] {exc} preset batch B=4, 256 steps", got, ref)
    return launches, dict(preprocess=pre_s, **walls)


def drive_phase19(classic, fused_prep, dev, card):
    """Phase 19: the classic pipeline on phase 4's run (preprocessing,
    scoring) and the preset-driven strings.  Returns the preset runs'
    kernel launches by specialization."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.tasks import process_training_data as ptd
    from torch_fdtd_string_tpu_torch.utils.config import compose

    root_dir = os.path.join(ROOT, "results")
    run_name = os.path.basename(classic["save_dir"])
    prep = os.path.join(root_dir, "chip_smoke_19_prep")
    shutil.rmtree(prep, ignore_errors=True)
    over = ["experiment=process_training_data", f"task.root_dir={root_dir}",
            f"task.result_dir={run_name}", "task.save_dir=chip_smoke_19_prep"]
    t0 = time.perf_counter()
    port_run.main(over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    items = sorted(os.listdir(prep))
    if items != classic["items"]:
        raise AssertionError(f"[19] prepared {items} of {classic['items']}")
    for d in items:
        if not ptd.is_processed(os.path.join(prep, d), 256):
            raise AssertionError(f"[19] {d} incomplete")
        z = np.load(os.path.join(prep, d, "parameters.npz"))
        for key in z.files:
            if z[key].dtype.kind == "f" and not np.isfinite(z[key]).all():
                raise AssertionError(f"[19] {d}: {key} not finite")
    print(f"[19] (a) experiment=process_training_data on phase 4's run: {len(items)} items "
          f"complete and finite (256 ut and ua wavs, vt.wav, parameters.npz), wall "
          f"{wall:.2f} s = {wall / len(items):.3f} s per item [{card}]")
    again = ptd.process(compose(port_run.CONFIG_DIR, over))
    if again != 0:
        raise AssertionError(f"[19] the second call processed {again} items")
    print("[19] a second call processes nothing")
    bank_ms, host_ms = check_bank(os.path.join(prep, items[0]), dev, card)
    check_classic_against_fused(classic["save_dir"], prep, fused_prep, card)

    t0 = time.perf_counter()
    port_run.main(["experiment=evaluate", f"task.load_dir={classic['save_dir']}"])
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port_run.main(["proc.simulate=false", "proc.summarize=true",
                   f"task.load_dir={classic['save_dir']}"])
    sum_s = time.perf_counter() - t0
    check_scores(classic["save_dir"], len(classic["items"]), card)
    print(f"[19] (b) experiment=evaluate {eval_s:.2f} s, proc.summarize {sum_s:.3f} s for "
          f"{len(classic['items'])} items [{card}]")

    launches, walls = drive_presets(dev, card)
    print(f"[19] (c) presets: preprocess_data {walls['preprocess']:.2f} s, bowed run "
          f"{walls['bow']:.2f} s, hammered run {walls['hammer']:.2f} s (B=4, 1 s) [{card}]")
    print(f"[19] walls: preprocessing {wall:.2f} s ({wall / len(items):.3f} s per item), "
          f"modal bank {bank_ms:.3f} ms per item on the card against {host_ms:.1f} ms on "
          f"the host, evaluate {eval_s:.2f} s, summarize {sum_s:.3f} s [{card}]")
    return launches


# phase 20: the sharded paths (parallel/mesh.py) on two ranks.  Two ranks
# share the one card on gloo (NCCL refuses two ranks on one card): they
# measure the path, not scaling.  The sharded generation must equal the
# single-card run bit for bit (each string at its whole-batch width group)
# but for the device post-processing's YIN track (SHARD_F0_REL below);
# the float64 parameters after SHARD_STEPS data-parallel steps the
# single-card steps' within SHARD_PARAM64 of each tensor's scale, the
# float32 losses within SHARD_LOSS32 (both set before the first card run;
# read: 2.0e-14 and 2.2e-7).  proc.train for one epoch (4 steps) on two
# ranks against one card, float32: the first step's losses within
# SHARD_LOSS32 (the same batch, weights and noise; read 1.1e-7), the
# checkpoint's per-tensor distance, relative to each tensor's scale,
# within SHARD_TRAIN32 = (median, largest).  Both runs now repeat bit for
# bit (phase 18), so what parts them is the all-reduce's summation order
# alone, compounded by the float32 gradient's sensitivity to it (PERF.md);
# the losses part at the fourth step (1.7e-4).  Read with the fixed-order
# ops: median 1.805e-6, largest 7.335e-2 on a zero-initialised bias whose
# scale is its four updates (before them, runs that did not repeat: 2.3e-6
# and 8.9e-2, bounds 1e-4 and 0.5); bounds about twice the reading
SHARD_STEPS, SHARD_PARAM64, SHARD_LOSS32 = 2, 1e-9, 1e-5
SHARD_TRAIN32 = (4e-6, 0.15)
SHARD_TIMEOUT_S = 300


def np_rel(ref, got):
    """max |got - ref| / max |ref| of two arrays."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(tag, job, cards, backend):
    """Start ``chip_smoke.py --rank`` as ``len(cards)`` ranks of one group
    (torchrun's variables; rank r on card ``cards[r]``), each from the
    checkout's root; :func:`finish_ranks` waits for them."""
    out = os.path.join(ROOT, "results", f"chip_smoke_20_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    port = free_port()
    group = dict(tag=tag, out=out, n=len(cards), procs=[], logs=[],
                 t0=time.perf_counter())
    for r, card_index in enumerate(cards):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(len(cards)), RANK=str(r), LOCAL_RANK=str(card_index))
        group["logs"].append(open(os.path.join(out, f"rank{r}.log"), "w"))
        group["procs"].append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank",
             json.dumps(dict(job, out=out, backend=backend))],
            env=env, cwd=ROOT, stdout=group["logs"][-1], stderr=subprocess.STDOUT))
    return group


def stop_ranks(group):
    """Kill the group's ranks that still run and close their logs."""
    for p in group["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
    for log in group["logs"]:
        log.close()


def finish_ranks(group):
    """Wait for the ranks of :func:`start_ranks`.  A rank that fails or
    outlives SHARD_TIMEOUT_S from the start stops them all and fails the
    phase.  Returns the ranks' JSON results, in rank order, their output
    directory and the wall since the start."""
    procs, tag, out, t0 = group["procs"], group["tag"], group["out"], group["t0"]
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                failed = f"timed out after {SHARD_TIMEOUT_S} s"
                break
            time.sleep(0.2)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = f"exit codes {[p.returncode for p in procs]}"
    finally:
        stop_ranks(group)
    wall = time.perf_counter() - t0
    if failed:
        for r in range(group["n"]):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                print(f"[20] {tag} rank {r} log (end):\n{f.read()[-4000:]}", file=sys.stderr)
        raise AssertionError(f"[20] {tag}: {failed}")
    results = []
    for r in range(group["n"]):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, out, wall


def dmsp_steps(over, dev, n_steps, dtypes, shard):
    """``n_steps`` train steps of synth-dmsp's model at full width on the
    first global batches of the train split, built as ``trainer.train``
    builds them (``trainer.build_training``: the model from ``proc.seed``,
    the configured optimizer, schedule, clipping, criteria and registry;
    ``trainer.train_state``: the noise from the step's seed); with
    ``shard``, the data-parallel step on this rank's rows.  Per dtype: the
    losses of each step, the parameters after the last (float64, on the
    host) and the steps' seconds (CUDA synchronised)."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.data.dataset import DataLoader, Trainset
    from torch_fdtd_string_tpu_torch.parallel import mesh
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    args = compose(port_run.CONFIG_DIR, over)
    task, seed = args.task, int(args.proc.seed)
    B = int(task.batch_size)
    data = Trainset(task.load_dir, task.load_name)
    total_steps = int(task.total_epoch) * max(len(data) // B, 1)
    preps = []
    for _, batch in zip(range(n_steps), DataLoader(data, B)):
        prep = S.prepare_batch(mesh.shard_batch(batch, B) if shard else batch,
                               args.model.n_modes, args.model.block_size, task.sr)
        prep.pop("analytic")
        preps.append(S.to_device(prep, dev))
    out = {}
    for dtype in dtypes:
        setup = trainer.build_training(args, dev, total_steps, dtype=dtype, sharded=shard)
        mesh.replicate(setup.model)
        state = trainer.train_state(setup.model, setup.optimizer, seed, 0, dev)
        losses = []
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        for prep in preps:
            state, ld = setup.train_step(state, {k: v.to(dtype) for k, v in prep.items()})
            losses.append({k: float(v) for k, v in ld.items()})
        sync()
        out[str(dtype)] = dict(
            losses=losses, secs=time.perf_counter() - t0,
            params={k: q.detach().double().cpu().numpy()
                    for k, q in setup.model.named_parameters()})
        del setup, state
    return out


def logged_training(fn):
    """``fn()`` with the trainer's device caches and train steps recorded:
    returns ``(fn's result, the items of each cache built, each step's
    losses)``; the losses are the global batch's (all-reduced) on every
    rank."""
    from torch_fdtd_string_tpu_torch.tasks import synthesize as S
    from torch_fdtd_string_tpu_torch.tasks import trainer

    caches, losses = [], []
    device_cache, make_step = trainer._device_cache, S.make_train_step

    def logged_cache(*a, **kw):
        gather, n_items = device_cache(*a, **kw)
        caches.append(n_items)
        return gather, n_items

    def logged_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def logged_step(state, prep):
            state, ld = step(state, prep)
            losses.append({k: float(v) for k, v in ld.items()})
            return state, ld

        return logged_step

    trainer._device_cache, S.make_train_step = logged_cache, logged_make_step
    try:
        return fn(), caches, losses
    finally:
        trainer._device_cache, S.make_train_step = device_cache, make_step


def rank_worker(job):
    """One rank of a phase-20 group (``--rank``): joins it, runs the job
    (``generate``: ``run.main`` of a fused run; ``train``: ``run.main`` of
    ``proc.train``, then the data-parallel steps), leaves its JSON result
    (and rank 0 its float64 parameters) in ``job["out"]``."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.parallel import mesh

    r = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if job["what"] == "nccl1":
        result = nccl_one_rank(job)
    else:
        if not mesh.init_distributed(backend=job["backend"]):
            raise AssertionError("no process group")
        result = dict(init_s=time.perf_counter() - t0, backend=job["backend"],
                      device=str(mesh.local_device()))
        try:
            if job["what"] == "generate":
                from torch_fdtd_string_tpu_torch.ops.string_kernel import (
                    reset_launch_counts,
                    string_chunked,
                    string_chunked_bucketed,
                )

                reset_launch_counts()
                t1 = time.perf_counter()
                port_run.main(job["overrides"])
                torch.cuda.synchronize()
                result.update(wall=time.perf_counter() - t1,
                              launches=string_chunked_bucketed.launches,
                              by_spec=dict(string_chunked.launches_by_spec))
            else:
                t1 = time.perf_counter()
                _, caches, losses = logged_training(lambda: port_run.main(job["overrides"]))
                torch.cuda.synchronize()
                result.update(train_wall=time.perf_counter() - t1, caches=caches,
                              losses=losses)
                steps = dmsp_steps(job["over"], mesh.local_device(), SHARD_STEPS,
                                   (torch.float64, torch.float32), shard=True)
                if r == 0:
                    for dtype in (torch.float64, torch.float32):
                        np.savez(os.path.join(job["out"], f"params{str(dtype)[-2:]}.npz"),
                                 **steps[str(dtype)]["params"])
                result["steps"] = {k: dict(losses=v["losses"], secs=v["secs"])
                                   for k, v in steps.items()}
        finally:
            mesh.destroy()
    with open(os.path.join(job["out"], f"rank{r}.json"), "w") as f:
        json.dump(result, f)
    return 0


def nccl_one_rank(job):
    """Phase 20 (c): a one-rank NCCL group on the card: its start, an
    all-reduce and an all-gather through the port's collectives, and one
    data-parallel train step (every collective of the step run) against
    the plain step, float64."""
    import torch.distributed as dist

    from torch_fdtd_string_tpu_torch.parallel import mesh

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(16.0, device="cuda")
        y = mesh.all_reduce(x.clone(), mean=True)
        g = mesh.all_gather_rows(x[None])
        torch.cuda.synchronize()
        ok = bool(torch.equal(x, y)) and tuple(g.shape) == (1, 16)
        init_s = time.perf_counter() - t0
        plain = dmsp_steps(job["over"], torch.device("cuda"), 1, (torch.float64,), False)
        sharded = dmsp_steps(job["over"], torch.device("cuda"), 1, (torch.float64,), True)
        key = str(torch.float64)
        err = max(np_rel(plain[key]["params"][k], sharded[key]["params"][k])
                  for k in plain[key]["params"])
        loss_err = abs(sharded[key]["losses"][0]["loss"] - plain[key]["losses"][0]["loss"])
    finally:
        dist.destroy_process_group()
    return dict(backend="nccl", init_s=init_s, collectives_ok=ok, param_err=err,
                loss_err=loss_err, step_s=sharded[key]["secs"], plain_s=plain[key]["secs"])


# the prepared item's field that the device post-processing computes with
# batched cuBLAS products and cuFFT transforms, whose kernels the batch's
# size chooses, so that a rank's half batch may round it otherwise: the
# YIN track ut_f0, held within SHARD_F0_REL per frame (read: 2.43e-7 at
# most, in 5 of 23 items).  Every other file and field, the ut and vt wavs
# among them, bit for bit.
SHARD_F0_REL = 1e-5
DEVICE_KEYS = ("ut_f0",)


def same_files(a, b, wavio, device_diff=None):
    """Whether the directories ``a`` and ``b`` hold the same files with the
    same contents: ``.npz`` arrays and wav samples equal bit for bit (NaN
    where NaN), every other file byte for byte; ``None`` or what differs.
    With ``device_diff`` (a dict), DEVICE_KEYS' largest relative
    difference per frame is measured into it instead."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return f"files {names} against {sorted(os.listdir(b))}"
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            if za.files != zb.files:
                return f"{name}: keys"
            for key in za.files:
                if device_diff is not None and key in DEVICE_KEYS:
                    ref, got = np.asarray(za[key], np.float64), np.asarray(zb[key], np.float64)
                    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
                    device_diff[key] = max(device_diff.get(key, 0.0), float(rel.max()))
                elif not np.array_equal(za[key], zb[key],
                                        equal_nan=za[key].dtype.kind in "fc"):
                    return f"{name}: {key}"
        elif name.endswith(".wav"):
            if not np.array_equal(wavio.read(pa)[0], wavio.read(pb)[0]):
                return name
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    return name
    return None


def check_sharded_generation(tag, results, save_dir, ref, classic, card):
    """Phase 20 (a)/(d): the sharded fused run against phase 9's run of the
    same overrides, item by item: every file and field bit for bit but
    the device post-processing's ut_f0, within SHARD_F0_REL; its readouts
    against phase 4's classic run; the job files rank 0 wrote; the kernel
    launched on every rank.  Returns the group launches."""
    from torch_fdtd_string_tpu_torch.utils import wav as wavio

    for r, res in enumerate(results):
        if res["launches"] < 1:
            raise AssertionError(f"[20] {tag}: rank {r} launched no kernel: {res}")
    dirs, device_diff, n_exact = {}, {}, 0
    for where, d in (("run", save_dir), ("prep", save_dir + "-prep")):
        base = ref if where == "run" else ref + "-prep"
        items = sorted(x for x in os.listdir(d) if os.path.isdir(os.path.join(d, x))
                       and x != "codes")
        want = sorted(x for x in os.listdir(base) if os.path.isdir(os.path.join(base, x))
                      and x != "codes")
        if items != want:
            raise AssertionError(f"[20] {tag}: {where} items {items} against {want}")
        for item in items:
            one = {} if where == "prep" else None
            diff = same_files(os.path.join(base, item), os.path.join(d, item), wavio, one)
            if diff:
                raise AssertionError(f"[20] {tag}: {where} item {item} differs: {diff}")
            if one is not None:
                n_exact += not any(one.values())
                for key, v in one.items():
                    device_diff[key] = max(device_diff.get(key, 0.0), v)
        dirs[where] = len(items)
    same_readouts = 0
    for item in os.listdir(save_dir):
        npz = os.path.join(classic or "", item, "simulation.npz")
        if classic and os.path.exists(npz):
            z4, z = np.load(npz), np.load(os.path.join(save_dir, item, "simulation.npz"))
            if not all(np.array_equal(z4[k], z[k]) for k in ("uout", "zout")):
                raise AssertionError(f"[20] {tag}: {item}'s readouts differ from phase 4's")
            same_readouts += 1
    with open(os.path.join(save_dir, "skip_stats.json")) as f:
        batches = json.load(f)["batches"]
    with open(os.path.join(save_dir, "gpu_time.txt")) as f:
        times = f.read().split("\n")[:-1]
    with open(os.path.join(save_dir + "-prep", "_gen_meta.jsonl")) as f:
        meta = f.readlines()
    if [b["n"] for b in batches] != [24] or len(times) != 1 or len(meta) != 1:
        raise AssertionError(f"[20] {tag}: job files: batches {batches}, times {times}, "
                             f"meta {meta}")
    launches = sum(res["launches"] for res in results)
    print(f"[20] {tag}: {dirs['run']} run-dir items equal phase 9's bit for bit (every npz "
          f"array, wav sample and file), {same_readouts} items' uout and zout phase 4's; "
          f"{dirs['prep']} prepared items bit for bit (wavs included) but ut_f0, itself "
          f"bit for bit in {n_exact} items, at most {device_diff.get('ut_f0', 0.0):.3e} "
          f"per frame (bound {SHARD_F0_REL}); "
          f"one skip-stats batch of 24, one timing line, one provenance line; bucketed "
          f"launches per rank {[res['launches'] for res in results]}, by specialization "
          f"{[res['by_spec'] for res in results]} [{card}]")
    if device_diff.get("ut_f0", 0.0) > SHARD_F0_REL:
        raise AssertionError(f"[20] {tag}: the device post-processing's ut_f0 {device_diff}")
    return launches


def check_sharded_steps(tag, results, out, ref, card):
    """Phase 20 (b)/(d): the data-parallel steps against the single-card
    steps ``ref`` of the same batches; the float32 parameters' distance
    is printed, the yardstick of the float32 checkpoint's."""
    f64, f32 = str(torch.float64), str(torch.float32)
    err = {}
    for dt in (f64, f32):
        got = np.load(os.path.join(out, f"params{dt[-2:]}.npz"))
        err[dt] = [np_rel(ref[dt]["params"][k], got[k]) for k in ref[dt]["params"]]
    err64 = max(err[f64])
    steps = results[0]["steps"]
    loss64 = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-30)
                 for a, b in zip(ref[f64]["losses"], steps[f64]["losses"]) for k in a)
    loss32 = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-30)
                 for a, b in zip(ref[f32]["losses"], steps[f32]["losses"]) for k in a)
    secs = {k: [res["steps"][k]["secs"] for res in results] for k in (f64, f32)}
    print(f"[20] {tag}: {SHARD_STEPS} synth-dmsp steps at full width, the global batch "
          f"of {DMSP_TRAIN_BATCH} split {DMSP_TRAIN_BATCH // len(results)} per rank: "
          f"float64 parameters {err64:.3e} of scale from the single-card steps (bound "
          f"{SHARD_PARAM64}), losses {loss64:.3e}; float32 losses {loss32:.3e} (bound "
          f"{SHARD_LOSS32}), parameters median {float(np.median(err[f32])):.3e}, largest "
          f"{max(err[f32]):.3e} of scale; steps' seconds per rank float64 "
          f"{[round(x, 3) for x in secs[f64]]} (single card {ref[f64]['secs']:.3f}), "
          f"float32 {[round(x, 3) for x in secs[f32]]} (single card "
          f"{ref[f32]['secs']:.3f}) [{card}]")
    if not (err64 <= SHARD_PARAM64 and loss32 <= SHARD_LOSS32):
        raise AssertionError(f"[20] {tag}: sharded steps off the single-card steps")


def check_sharded_training(tag, results, run_dir, one_dir, one_losses, init, card):
    """Phase 20 (b)/(d): ``proc.train`` for one epoch on the ranks against
    the single-card run ``one_dir`` of the same overrides (``one_losses``
    its steps' losses): rank 0 cached the three splits and every other
    rank the train split alone; the run holds the epoch's valid record,
    ``profile.json`` counts its steps, ``BEST`` and the checkpoint of its
    last step are there; the first step's global losses are the
    single-card step's within SHARD_LOSS32 (the same batch, weights and
    noise); the checkpoint's float32 parameters are the single-card run's
    within SHARD_TRAIN32 of each tensor's scale (median and largest),
    beside how far the epoch moved each tensor from ``init``, the initial
    weights."""
    from torch_fdtd_string_tpu_torch.tasks import trainer

    def valid(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r.get("split") == "valid"]

    v1, v2 = valid(one_dir), valid(run_dir)
    spe = int(v1[0]["step"])
    caches = [res["caches"] for res in results]
    with open(os.path.join(run_dir, "profile.json")) as f:
        steps = json.load(f)["train_step"]["count"]
    ckdir = trainer._ckpt_dir(run_dir)
    if not (len(caches[0]) == 3 and all(c == caches[0][:1] for c in caches[1:])
            and [int(r["step"]) for r in v2] == [spe] and steps == spe
            and all(len(res["losses"]) == spe for res in results) and len(one_losses) == spe
            and os.path.exists(os.path.join(ckdir, "BEST"))):
        raise AssertionError(f"[20] {tag}: caches {caches}, valid records {v2}, "
                             f"{steps} steps, checkpoints {os.listdir(ckdir)}")
    loss_err = [max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-30) for k in a)
                for a, b in zip(one_losses, results[0]["losses"])]
    load = lambda d: torch.load(os.path.join(trainer._ckpt_dir(d), f"step_{spe}.pt"),
                                map_location="cpu", weights_only=True)["params"]
    one, two = load(one_dir), load(run_dir)
    errs = {k: np_rel(one[k].numpy(), two[k].numpy()) for k in one}
    worst = max(errs, key=errs.get)
    median = float(np.median(list(errs.values())))
    moved = {k: np_rel(one[k].numpy(), init[k]) for k in one}
    print(f"[20] {tag}: proc.train, one epoch of {spe} steps of {DMSP_TRAIN_BATCH} "
          f"({DMSP_TRAIN_BATCH // len(results)} rows per rank): the ranks' device caches "
          f"{caches} items, profile.json train_step {steps}; the steps' global losses "
          f"against the single card's, largest relative difference per step "
          f"{[f'{e:.2e}' for e in loss_err]} (first step bound {SHARD_LOSS32}); valid/loss "
          f"{v2[0]['valid/loss']:.6f} (single card {v1[0]['valid/loss']:.6f}); the float32 "
          f"checkpoint of scale from the single-card run's: median over "
          f"{len(errs)} tensors {median:.3e}, largest "
          f"{errs[worst]:.3e} ({worst}, which the epoch moved {moved[worst]:.3e} from its "
          f"initial weights; median move {float(np.median(list(moved.values()))):.3e}; "
          f"bound {SHARD_TRAIN32}); run.main per rank "
          f"{[round(res['train_wall'], 2) for res in results]} s [{card}]")
    if (loss_err[0] > SHARD_LOSS32 or median > SHARD_TRAIN32[0]
            or errs[worst] > SHARD_TRAIN32[1]):
        raise AssertionError(f"[20] {tag}: the sharded run is off the single-card one")


def drive_phase20(fused_dir, classic_dir, train_over, dev, card):
    """Phase 20: sharded generation and training on two ranks of the card
    (gloo), a one-rank NCCL group, and both paths across two cards on
    NCCL where there are two.  Returns the bucketed launches of the
    sharded generation runs."""
    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.utils.config import compose

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    launches = 0
    over = FUSED + [f"task.root_dir={os.path.join(ROOT, 'results')}",
                    "task.randomize_name=false"]
    runs = [("(a)", [0, 0], "gloo")]
    if torch.cuda.device_count() >= 2:
        runs.append(("(d)", [0, 1], "nccl"))
    else:
        print(f"[20] (d) skipped: {torch.cuda.device_count()} card on this host; the "
              "two-card NCCL runs need two")
    started = []

    def start(tag, job, cards, backend):
        started.append(start_ranks(tag, job, cards, backend))
        return started[-1]

    def start_generation(tag, cards, backend):
        name = f"chip_smoke_20{tag[1]}"
        for d in (name, name + "-prep"):
            shutil.rmtree(os.path.join(ROOT, "results", d), ignore_errors=True)
        return start(f"gen{tag[1]}", dict(
            what="generate", overrides=over + [f"task.save_name={name}"]), cards, backend)

    try:
        # the first generation run needs nothing of what follows: it runs
        # beside the single-card references
        first_gen = start_generation(*runs[0])
        ref = dmsp_steps(train_over, dev, SHARD_STEPS, (torch.float64, torch.float32), False)
        # proc.train for one epoch, no proc.test, on one card: what the ranks'
        # run is held to
        epoch = train_over + ["task.total_epoch=1", "proc.test=false"]
        one_dir = os.path.join(ROOT, "results", "chip_smoke_20_train1")
        shutil.rmtree(one_dir, ignore_errors=True)
        (wall1, _), _, one_losses = logged_training(lambda: train_run(epoch, one_dir))
        init = {k: q.detach().numpy() for k, q in trainer.build_training(
            compose(port_run.CONFIG_DIR, epoch), torch.device("cpu"), 1).model.named_parameters()}
        args = dict(o.split("=", 1) for o in train_over)
        prep_dir = os.path.join(args["task.load_dir"], args["task.load_name"])
        print(f"[20] (b) proc.train on one card, one epoch: wall {wall1:.2f} s [{card}]")
        torch.cuda.empty_cache()
        nccl = start("nccl", dict(what="nccl1", over=train_over), [0], "nccl")
        for tag, cards, backend in runs:
            gen = first_gen if tag == runs[0][0] else start_generation(tag, cards, backend)
            step_tag = "(b)" if tag == "(a)" else "(d)"
            # rank 0 writes the host caches anew, the other rank loads them
            for path in glob.glob(os.path.join(prep_dir, "_prep_*.npz")):
                os.remove(path)
            run_dir = os.path.join(ROOT, "results", f"chip_smoke_20{step_tag[1]}_train")
            shutil.rmtree(run_dir, ignore_errors=True)
            steps = start(f"steps{tag[1]}", dict(
                what="train", over=train_over, overrides=epoch + [
                    f"task.root_dir={os.path.dirname(run_dir)}",
                    f"task.save_name={os.path.basename(run_dir)}"]), cards, backend)
            results, _, wall = finish_ranks(gen)
            print(f"[20] {tag} experiment=nsynth-like task.num_samples=24 (B=24, 1 s) on 2 "
                  f"{backend} ranks, cards {cards}: wall {wall:.2f} s with start-up; per rank "
                  f"group start {[round(x['init_s'], 2) for x in results]} s, run.main "
                  f"{[round(x['wall'], 2) for x in results]} s"
                  + (" (two ranks on one card measure the path, not scaling)"
                     if cards[0] == cards[1] else "") + f" [{card}]")
            launches += check_sharded_generation(
                tag, results, os.path.join(ROOT, "results", f"chip_smoke_20{tag[1]}"),
                fused_dir, classic_dir, card)
            results, out, wall = finish_ranks(steps)
            print(f"[20] {step_tag} data-parallel training on 2 {backend} ranks, cards "
                  f"{cards}: wall {wall:.2f} s with start-up [{card}]")
            check_sharded_training(step_tag, results, run_dir, one_dir, one_losses, init,
                                   card)
            check_sharded_steps(step_tag, results, out, ref, card)
        (res,), _, wall = finish_ranks(nccl)
    finally:
        for group in started:
            stop_ranks(group)
    print(f"[20] (c) one-rank NCCL group: started in {res['init_s']:.2f} s, all-reduce and "
          f"all-gather {'right' if res['collectives_ok'] else 'WRONG'}; one data-parallel "
          f"step (float64, batch {DMSP_TRAIN_BATCH}) against the plain step: parameters "
          f"{res['param_err']:.3e} of scale, loss {res['loss_err']:.3e}; step "
          f"{res['step_s']:.3f} s, plain {res['plain_s']:.3f} s; wall {wall:.2f} s [{card}]")
    if not (res["collectives_ok"] and res["param_err"] <= SHARD_PARAM64):
        raise AssertionError(f"[20] (c): {res}")
    print(f"[20] phase wall {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


def drive_phase21(dmsp_over, card):
    """Phase 21: the figures and a JAX-trained run on the card's host.
    Without matplotlib ``experiment=linear-string task.plot=true`` raises
    the ImportError naming ``task.plot=false`` before any work; with it a
    run of a few steps draws the item's figures.  Without tensorstore,
    ``proc.test`` on a run directory in the JAX package's layout (an orbax
    ``step_<n>/``) raises the ImportError naming
    ``tools/convert_orbax.py``."""
    import importlib.util

    from torch_fdtd_string_tpu_torch import run as port_run

    root = os.path.join(ROOT, "results", "chip_smoke_21")
    shutil.rmtree(root, ignore_errors=True)
    over = ["experiment=linear-string", "task.precision=single", "task.length=0.002",
            f"task.root_dir={root}", "task.save_name=plot"]
    if importlib.util.find_spec("matplotlib") is None:
        try:
            port_run.main(over)
        except ImportError as err:
            if "task.plot=false" not in str(err) or glob.glob(os.path.join(root, "plot", "*-*")):
                raise AssertionError(f"[21] task.plot=true: {err!r}") from err
            print(f"[21] no matplotlib on this host: task.plot=true raised before any work: "
                  f"{err} [{card}]")
        else:
            raise AssertionError("[21] task.plot=true ran on a host without matplotlib")
    else:
        port_run.main(over)
        drawn = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(root, "plot", "0-0", "*.p*")))
        want = {"spec.pdf", "f0.pdf", "phs.pdf", "string.png", "hammer.png"}
        if not want <= set(drawn):
            raise AssertionError(f"[21] linear-string drew {drawn}")
        print(f"[21] matplotlib on this host: linear-string with its figures drew {drawn} "
              f"[{card}]")
    step_dir = os.path.join(root, "jax_run", "string", "ckpt", "checkpoints", "step_3")
    os.makedirs(step_dir)
    with open(os.path.join(step_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": {}, "use_zarr3": False}, f)
    if importlib.util.find_spec("tensorstore") is not None:
        print(f"[21] tensorstore on this host: a JAX run is served as on the CPU host [{card}]")
        return
    try:
        port_run.main(dmsp_over + [f"task.ckpt_dir={os.path.join(root, 'jax_run')}",
                                   f"task.root_dir={root}", "task.save_name=jax_test"])
    except ImportError as err:
        if "tools/convert_orbax.py" not in str(err):
            raise AssertionError(f"[21] a JAX run: {err!r}") from err
        print(f"[21] proc.test on a JAX run directory (orbax step_3/), no tensorstore on this "
              f"host: {err} [{card}]")
    else:
        raise AssertionError("[21] a JAX run was scored without tensorstore")


def same_outputs(a, b):
    """Every wav (byte for byte) and every ``.npz`` array (bit for bit) under
    run directory ``a`` equals its namesake under ``b``, and neither has one
    the other lacks; returns how many files were compared."""
    def files(top):
        return sorted(os.path.relpath(p, top) for p in glob.glob(os.path.join(top, "**", "*"),
                                                                 recursive=True)
                      if p.endswith((".wav", ".npz")) and os.sep + "codes" + os.sep not in p)

    names = files(a)
    if not names or names != files(b):
        raise AssertionError(f"the runs wrote other files: {len(names)} and {len(files(b))}")
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".wav"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"{name} differs")
            continue
        with np.load(pa) as za, np.load(pb) as zb:
            if sorted(za.files) != sorted(zb.files) or not all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k], equal_nan=True)
                    for k in za.files):
                raise AssertionError(f"{name} differs")
    return len(names)


def drive_phase22(train_over, dev, card):
    """Phase 22: the port alone, the profiling scopes and the five tools.
    (a) a copy of ``torch_fdtd_string_tpu_torch/`` alone (no JAX package
    beside it, importing jax or the JAX package refused) runs
    ``python -m torch_fdtd_string_tpu_torch.run experiment=nsynth-like`` at
    a cut size in a process of its own (its ``build/`` seeded with the
    checkout's kernel library and root table, so that it builds neither);
    the same overrides through ``run.main`` here; every item of the two
    equal bit for bit, the standalone snapshot holding ``configs/``.  (b)
    ``utils/profiling.py::device_timer`` around a bucketed launch against
    the launch's CUDA events, in turns; ``trace``'s Chrome trace names a
    ``string_step`` kernel.  (c) ``tools.batch_sweep`` at B 16, 32 and
    ``tools.length_sweep`` at 0.25, 0.5 s, one rep each.  (d)
    ``tools.prebuild_cache`` over phase 18's corpus, its caches equal to the
    trainer's own, which the trainer then loads; ``tools.yin_accuracy --n
    5``; ``tools.attrition_study`` over a cut run of phase 12's poisoned
    draw with every draw dumped.  (e) ``dryrun_train_step`` on the card.
    Returns the bucketed launches of (a)'s run here and the GMRES
    instances' launches of (c) (counts set to 0 just before each, read just
    after)."""
    import contextlib
    import io

    from torch_fdtd_string_tpu_torch import run as port_run
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk
    from torch_fdtd_string_tpu_torch.tasks import trainer
    from torch_fdtd_string_tpu_torch.tools import (attrition_study, batch_sweep, length_sweep,
                                                   prebuild_cache, yin_accuracy)
    from torch_fdtd_string_tpu_torch.data.dataset import Trainset
    from torch_fdtd_string_tpu_torch.utils import profiling
    from torch_fdtd_string_tpu_torch.utils.config import compose

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "results", "chip_smoke_22")
    shutil.rmtree(root, ignore_errors=True)
    alone = os.path.join(root, "alone")
    shutil.copytree(os.path.join(ROOT, "torch_fdtd_string_tpu_torch"),
                    os.path.join(alone, "torch_fdtd_string_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    seeded = glob.glob(os.path.join(ROOT, "build", "kernels", "libstring_step.so")) + glob.glob(
        os.path.join(ROOT, "build", "cache", "analytic_roots_*.npz"))
    for path in seeded:  # copy2 keeps the library newer than its copied source
        dst = os.path.join(alone, os.path.relpath(path, ROOT))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(path, dst)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", REFUSE_JAX, *ALONE, "task.save_name=run"],
                         cwd=alone, env=env, capture_output=True, text=True, timeout=300)
    alone_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"[22] (a) the package alone exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    snapshot = os.path.join(alone, "results", "run", "codes", "torch_fdtd_string_tpu_torch",
                            "configs")
    if not os.path.isfile(os.path.join(snapshot, "config.yaml")):
        raise AssertionError("[22] (a) the standalone run's codes/ holds no configs/")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    here = port_run.main(ALONE + [f"task.root_dir={root}", "task.save_name=run"])
    torch.cuda.synchronize()
    here_s = time.perf_counter() - t0
    bucketed = sum(sk.string_chunked.launches_by_spec.values())
    if bucketed < 1:
        raise AssertionError("[22] (a) the run launched no string kernel")
    n_files = sum(same_outputs(d, os.path.join(alone, "results", os.path.basename(d)))
                  for d in (here, here + "-prep"))
    print(f"[22] (a) the package alone ({len(seeded)} build files seeded): "
          f"{' '.join(ALONE)}: exit 0 in {alone_s:.2f} s with start-up; from the "
          f"repository {here_s:.2f} s, launches {dict(sk.string_chunked.launches_by_spec)}; "
          f"{n_files} wav and npz files equal bit for bit; codes/ holds configs/ [{card}]")

    # (b) device_timer against CUDA events around one bucketed launch, in turns
    args, kwargs = nsynth_inputs(FUSED, dev)
    hb = host_bounds(args)
    launch = lambda: sk.string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
    launch()
    torch.cuda.synchronize()
    event_ms, timer_ms, log = [], [], {}
    for _ in range(2):
        event_ms.append(timed_once(launch)[1])
        with profiling.device_timer("bucketed", log):
            launch()
        timer_ms.append(1e3 * log["bucketed"][-1])
    worst = max(abs(t - e) / e for t, e in zip(timer_ms, event_ms))
    if worst > TIMER_REL:
        raise AssertionError(f"[22] (b) device_timer {timer_ms} ms against CUDA events "
                             f"{event_ms} ms")
    trace_dir = os.path.join(root, "trace")
    with profiling.trace(trace_dir) as prof:
        launch()
        torch.cuda.synchronize()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    kernels = sorted({n for n in names if "string_step" in n})
    if not kernels:
        raise AssertionError("[22] (b) the trace names no string_step kernel")
    device_us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                    if "string_step" in e.key)
    print(f"[22] (b) bucketed launch of phase 9's first batch (B={args[0].shape[0]}, "
          f"{args[0].shape[1]} steps): device_timer {', '.join(f'{t:.3f}' for t in timer_ms)} ms, "
          f"CUDA events {', '.join(f'{e:.3f}' for e in event_ms)} ms (largest gap "
          f"{100 * worst:.2f}%); trace.json names {kernels[0][:80]}, device time "
          f"{device_us / 1e3:.3f} ms [{card}]")

    # (c) the sweeps: each point one JSON line, then the closing line
    sk.reset_launch_counts()
    sweeps = {"batch": batch_sweep.main(["--batches", "16,32", "--reps", "1"]),
              "length": length_sweep.main(["--lengths", "0.25,0.5", "--reps", "1"])}
    gm = dict(sk.string_chunked.launches_by_spec)
    for tag, rows in sweeps.items():
        if not all(np.isfinite(r["audio_s_per_s"]) and r["audio_s_per_s"] > 0 for r in rows):
            raise AssertionError(f"[22] (c) {tag} sweep: {rows}")
        print(f"[22] (c) {tag} sweep: " + "; ".join(
            f"B={r['B']} {r['length_s']} s {r['audio_s_per_s']:.2f} audio-s/s" for r in rows)
            + f" [{card}]")
    print(f"[22] (c) kernel launches {gm}")

    # (d) the tools on host data: prebuild_cache over phase 18's corpus
    opts = dict(o.split("=", 1) for o in train_over if o.startswith("task.load_"))
    data_dir, name = opts["task.load_dir"], opts["task.load_name"]
    own = {}
    for path in sorted(glob.glob(os.path.join(data_dir, name, "_prep_*.npz"))):
        with np.load(path) as z:  # the trainer's own build, in phase 18
            own[os.path.basename(path)] = {k: z[k] for k in z.files}
        os.remove(path)
    t0 = time.perf_counter()
    paths = prebuild_cache.main(["--load-name", name, "--data-dir", data_dir])
    built_s = time.perf_counter() - t0
    if sorted(os.path.basename(p) for p in paths) != sorted(own):
        raise AssertionError(f"[22] (d) prebuild_cache wrote {paths}, the trainer {sorted(own)}")
    for path in paths:
        with np.load(path) as z:
            want = own[os.path.basename(path)]
            if sorted(z.files) != sorted(want) or not all(
                    np.array_equal(z[k], want[k]) for k in z.files):
                raise AssertionError(f"[22] (d) {path} is not the trainer's build")
    args22 = compose(port_run.CONFIG_DIR, train_over)
    trim = int(args22.task.train_lens * args22.task.sr)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer._build_host_cache(Trainset(data_dir, name, trim=trim),
                                  args22.model.n_modes, args22.model.block_size,
                                  args22.task.sr, cache_path=paths[0], drop=("analytic",))
    if "loaded host cache" not in out.getvalue():
        raise AssertionError(f"[22] (d) the trainer built its cache again: {out.getvalue()}")
    print(f"[22] (d) prebuild_cache over phase 18's corpus: {len(paths)} caches in "
          f"{built_s:.2f} s, each equal bit for bit to the trainer's own; the trainer loads "
          f"them and builds none [{card}]")
    t0 = time.perf_counter()
    rows = yin_accuracy.main(["--n", "5", "--out", os.path.join(root, "yin_accuracy.md")])
    errs = [r[4] for r in rows]
    if not all(np.isfinite(errs)):
        raise AssertionError(f"[22] (d) yin_accuracy rows {rows}")
    print(f"[22] (d) yin_accuracy --n 5: largest error {max(errs):.4f} Hz, "
          f"{time.perf_counter() - t0:.2f} s")
    sk.reset_launch_counts()
    run_dir = port_run.main(ATTRITION_RUN + [f"task.root_dir={root}",
                                             "task.save_name=attrition"])
    first_pass = dict(sk.string_chunked.launches_by_spec)
    n_nan = sum(str(d["why"]) == "nan" for d in attrition_study.load_draws(run_dir))
    if n_nan < 1:
        raise AssertionError("[22] (d) the attrition run's first pass poisoned no draw")
    t0 = time.perf_counter()
    record = attrition_study.main(["--run", run_dir, "--controls", "1", "--length", "0.002",
                                   "--out", os.path.join(root, "attrition_study.json")])
    if [r["group"] for r in record["rows"]].count("skip") != n_nan:
        raise AssertionError(f"[22] (d) attrition rows {record['rows']}")
    print(f"[22] (d) attrition_study over phase 12's draw ({' '.join(ATTRITION_RUN[-5:])}; "
          f"kernel launches {first_pass}): {n_nan} skipped, {len(record['rows']) - n_nan} "
          f"control; the float64 engine over 0.002 s on the card in "
          f"{time.perf_counter() - t0:.2f} s: " + "; ".join(
              f"{r['file']} {r['group']} alpha {r['alpha']} f0 {r['f0']} nan "
              f"{r['reference_nan']}" for r in record["rows"]) + f" [{card}]")

    # (e) the tiny data-parallel step's entry point, on the card
    losses = trainer.dryrun_train_step()
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"[22] (e) dryrun_train_step {losses}")
    print(f"[22] (e) dryrun_train_step on the card: {losses}")
    print(f"[22] phase wall {time.perf_counter() - t_phase:.2f} s [{card}]")
    return bucketed, gm


def add_gmres(acc, by_spec):
    for spec, n in by_spec.items():
        if spec.endswith("-gmres"):
            acc[spec] = acc.get(spec, 0) + n


# --ab's cases: (tag, draw, overrides, call).  Each draw comes from an input
# function that the checkouts' own chip_smoke.py has had since the option
# came in (ab_inputs); call is "flat" (string_chunked), "bucketed" or
# "pluck_chunked"
AB_CASES = (
    ("a", "bench", {}, "flat"), ("b", "nsynth", {}, "flat"),
    ("c", "bow", {}, "flat"), ("d", "hammer", {}, "flat"), ("e", "mix", {}, "flat"),
    ("f", "bench_pickup", {}, "flat"), ("g", "bow_pickup", {}, "flat"),
    ("h", "hammer_pickup", {}, "flat"), ("i", "mix_pickup", {}, "flat"),
    ("j", "pickup4", {}, "flat"),
    ("k", "fused", {}, "bucketed"), ("l", "corpus", {}, "bucketed"),
    ("m", "corpus_mix", {}, "bucketed"),
    ("n", "bench", dict(gmres_rescue=True, coupling_iters=1), "flat"),
    ("o", "strong", {}, "flat"),
    ("p", "mix", dict(gmres_rescue=True, coupling_iters=1), "flat"),
    ("s", "mms", {}, "flat"),
    ("t", "bench", dict(coupling_fixed=2), "flat"),
    ("u", "bench", {}, "pluck_chunked"),
    ("v", "bench256", {}, "flat"),
)


def ab_inputs(cs, name, dev):
    """One of AB_CASES' draws through a checkout's chip_smoke module."""
    if name == "bench256":  # the bench workload at the time sweep's largest batch
        return cs.bench_inputs(256, 0.02, 7, dev)
    if name.startswith("bench"):
        return cs.bench_inputs(4, 0.02, 7, dev, surface_integral=name == "bench")
    if name == "strong":
        return cs.strong_inputs(256, dev)
    if name == "mms":  # the twin's string
        return cs.mms_inputs([220.0], 48000, 256, [0.01], dev)[0]
    over = {"nsynth": [], "bow": cs.BOW16, "hammer": cs.HAMMER, "mix": cs.MIX}
    for key, extra in list(over.items()):
        over[key + "_pickup"] = extra + cs.PICKUP
    if name in over:
        return cs.nsynth_inputs(cs.NSYNTH + over[name], dev)
    return cs.nsynth_inputs({"pickup4": cs.PICKUP4, "fused": cs.FUSED,
                             "corpus": cs.CORPUS48,
                             "corpus_mix": cs.CORPUS48 + cs.MIX}[name], dev)


def ab_call(sk, call, args, kw, bucketing, plain=False):
    """A case's call ("flat", "bucketed" or "pluck_chunked") on ``args``,
    ``kw``: the kernel, or with ``plain`` its plain version; ``bucketing``
    holds the bucketed call's ``host_bounds`` or ``groups``."""
    if call == "bucketed":
        fn = sk.string_chunked_bucketed_reference if plain else sk.string_chunked_bucketed
        return lambda: fn(*args, **bucketing, **kw)
    if call == "pluck_chunked" and plain:
        return lambda: sk.string_chunked_reference(*args, gmres_rescue=True, **kw)
    fn = (sk.string_chunked_reference if plain else
          sk.pluck_chunked if call == "pluck_chunked" else sk.string_chunked)
    return lambda: fn(*args, **kw)


def ab_fields(call, out):
    """The output fields ``--ab`` saves of one case, by name."""
    if call == "pluck_chunked" and isinstance(out[2], tuple):
        return dict(zip(("uout", "zout", "u1", "u2", "z1", "z2", "state_u", "state_z"),
                        (out[0], out[1]) + tuple(out[2])))
    return dict(named_fields(out))


def ab_times(root, out_path, draws_dir=None, reference=False):
    """``--ab``'s run of one checkout, in a process of its own: the
    checkout's own chip_smoke inputs and string kernel.  Times every case
    of AB_CASES (CUDA events over 20 calls of 256 steps), saves every
    output field of each case to ``out_path`` (npz, ``tag/field``) with the
    times, and prints one line of times and the checkout's ptxas report.
    With ``draws_dir`` (``--float64``) it also runs each case once on its
    :func:`stacked_draws` (:func:`ab_draws`); the first checkout
    (``reference``) writes the float64 plain version's fields there for the
    later checkouts."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from torch_fdtd_string_tpu_torch.ops import build
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    dev = torch.device("cuda")
    # built anew from the checkout's source, so that ptxas reports on it
    lib = os.path.join(build.BUILD_DIR, "libstring_step.so")
    if os.path.exists(lib):
        os.remove(lib)
    build.load_kernel_library("string_step")
    report = {name: " | ".join(lines)
              for name, lines in ptxas_report(build.build_log.get("string_step", "")).items()}
    times, saved = {}, {}
    for case in AB_CASES:
        tag, _, _, call = case
        args, kw, hb = ab_case(cs, case, dev)
        fn = ab_call(sk, call, args, kw, dict(host_bounds=hb))
        out = {key: x.cpu().numpy() for key, x in ab_fields(call, fn()).items()}
        saved.update((f"{tag}/{key}", x) for key, x in out.items())
        times[tag] = cs.cuda_ms(fn, reps=20)
        if draws_dir:
            saved.update(ab_draws(sk, case, (args, kw), hb, out, draws_dir, reference))
    saved["ptxas"] = np.array(json.dumps(report))
    saved["times"] = np.array(json.dumps(times))
    np.savez(out_path, **saved)
    print(f"[ab] {root}: {json.dumps(times)} [{cs.smi()}]", flush=True)
    print(f"[ab] {root} ptxas: {json.dumps(report)}", flush=True)


def ab_case(cs, case, dev, steps=256):
    """One of AB_CASES through a checkout's chip_smoke module: its args and
    keywords over ``steps`` steps, and the host bounds of its bucketing."""
    _, name, over, call = case
    args, kw = cs.truncate(ab_inputs(cs, name, dev), steps)
    kw = dict(kw, **over)
    if call == "pluck_chunked":
        kw.pop("gmres_rescue")
    return args, kw, cs.host_bounds(args)


def ab_draws(sk, case, inputs, hb, unstacked, draws_dir, reference):
    """``--ab --float64``'s run of one case: the kernel once on AB_DRAWS
    :func:`stacked_draws` of ``inputs`` (a bucketed case's strings each in
    its own call's width group, from the host bounds ``hb``), its first
    draw held bit for bit to ``unstacked``, the case's own call.  The
    ``reference`` process also runs the float64 plain version of the
    stacked call and writes its fields to ``draws_dir``.  Returns the arrays to save: per field each
    string's distance from float64 and whether it is finite
    (:func:`string_errors`, ``e/tag/field`` and ``fin/tag/field``) and per
    string whether uout has a NaN (``nan/tag``); from the reference, also
    each field's b (:func:`field_bounds`, ``b/tag/field``), float64's own
    move per perturbed draw (:func:`float64_moves`, ``move/tag/field``) and
    its own poisoned strings (``nan64/tag``)."""
    tag, _, _, call = case
    B = inputs[0][0].shape[0]
    args, kw = stacked_draws(inputs, AB_DRAWS)
    bucketing = {}
    if call == "bucketed":
        groups = sk.bucket_groups(*hb, **{key: kw[key] for key in (
            "k", "theta_t", "lambda_c", "M_t", "M_l")})
        bucketing = dict(groups=stacked_groups(groups, B, AB_DRAWS))
    got = {key: x.cpu().numpy()
           for key, x in ab_fields(call, ab_call(sk, call, args, kw, bucketing)()).items()}
    for key, x in unstacked.items():
        if draw_block(key, got[key], 0, B).tobytes() != x.tobytes():
            raise AssertionError(f"[ab] ({tag}) {key}: the stacked call's first draw is not "
                                 "the call's result bit for bit")
    saved = {}
    if reference:
        args64, kw64 = cast_inputs((args, kw), torch.float64)
        x64 = {key: x.cpu().numpy() for key, x in ab_fields(
            call, ab_call(sk, call, args64, kw64, bucketing, plain=True)()).items()}
        gmres = call == "pluck_chunked" or bool(kw.get("gmres_rescue", True))
        bounds = field_bounds({key: draw_block(key, x, 0, B) for key, x in x64.items()}, gmres)
        moves = float64_moves(x64, AB_DRAWS)
        for key, x in x64.items():
            np.save(os.path.join(draws_dir, f"{tag}.{key}.npy"), x)
            saved[f"b/{tag}/{key}"], saved[f"move/{tag}/{key}"] = np.array(bounds[key]), moves[key]
        saved[f"nan64/{tag}"] = np.isnan(x64["uout"]).any(axis=1)
        del x64
    x64 = {key: np.load(os.path.join(draws_dir, f"{tag}.{key}.npy"), mmap_mode="r")
           for key in got}
    for key, (e, fin) in string_errors(x64, got).items():
        saved[f"e/{tag}/{key}"], saved[f"fin/{tag}/{key}"] = e, fin
    saved[f"nan/{tag}"] = np.isnan(got["uout"]).any(axis=1)
    return saved


def spill_bytes(lines):
    """Registers and spill bytes (stores plus loads) of one instance's
    ptxas lines."""
    import re

    text = " ".join(lines)
    regs = re.search(r"Used (\d+) registers", text)
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text))
    return (int(regs.group(1)) if regs else None), spills


def ab_ptxas(roots, paths):
    """Each instance's registers and spill bytes per checkout, from the
    saved ptxas reports.  Returns False if a checkout has no report, or a
    later one spills more than the first in an instance the first has."""
    reports = [json.loads(str(np.load(path)["ptxas"])) for path in paths]
    if not all(reports):
        print(f"[ab] ptxas: no report from {[r for r, p in zip(roots, reports) if not p]}")
        return False
    more = []
    for name in sorted(set().union(*reports)):
        cells = [spill_bytes(r[name].split(" | ")) if name in r else (None, None)
                 for r in reports]
        print(f"[ab] ptxas {name}: " + ", ".join(
            f"{os.path.basename(root) or root} {regs} registers, {sp} spill bytes"
            for root, (regs, sp) in zip(roots, cells)))
        first = cells[0][1]
        if first is not None and any(sp is not None and sp > first for _, sp in cells[1:]):
            more.append(name)
    print("[ab] ptxas: " + (f"instances spilling more than in {roots[0]}: {more}" if more
                            else f"no instance spills more than in {roots[0]}"))
    return not more


def ab_compare(roots, paths):
    """Every checkout's saved outputs against the first's, bit for bit:
    the largest difference per case and the count of differing words.
    Returns False on any difference."""
    ref = np.load(paths[0])
    same = True
    for root, path in zip(roots[1:], paths[1:]):
        got = np.load(path)
        if sorted(got.files) != sorted(ref.files):
            print(f"[ab] {root}: fields {sorted(set(got.files) ^ set(ref.files))} on "
                  "one side only")
            same = False
            continue
        worst = {}
        for key in ref.files:
            if key in ("ptxas", "times"):
                continue
            a, b = ref[key], got[key]
            if a.shape != b.shape:
                print(f"[ab] {root} {key}: shape {b.shape} against {a.shape}")
                same = False
                continue
            bits = int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))
            fin = np.isfinite(a) & np.isfinite(b)
            diff = float(np.abs(a[fin].astype(np.float64) - b[fin]).max(initial=0.0))
            tag = key.split("/")[0]
            w = worst.setdefault(tag, [0.0, 0])
            w[0], w[1] = max(w[0], diff), w[1] + bits
        print(f"[ab] {root} against {roots[0]}: largest difference per case "
              + ", ".join(f"({t}) {d:.3e} [{n} words differ]" for t, (d, n) in worst.items()))
        same = same and all(n == 0 for _, n in worst.values())
    return same


# --ab --float64: the fields held as state, and the draws held no slower
STATE_FIELDS = ("state_u", "state_z", "u1", "u2", "z1", "z2")
AB_SPEED_CASES = ("a", "b", "k", "l", "u")
# --ab's speed rule: a later checkout counts as slower on one of
# AB_SPEED_CASES if its mean exceeds the first checkout's by more than this
# share of it.  None: two checkouts that time the same code read up to
# 5.809% apart on one case (one turn 11% slow; PERF.md), past the 3% that
# an allowance may take, so the rule stays as strict as it was
AB_SPEED_ALLOWANCE = 0.0
# --ab --float64's draws of each case: the unperturbed inputs and 16
# ulp-perturbed copies.  The largest case, (v) at B=256, holds 115 MB of
# float32 outputs per copy (256 steps of state at M_t + M_l = 434 lanes) and
# 230 MB in float64: 2.0 GB and 3.9 GB on the card for 17 copies; the float64
# fields of all cases, 8.8 GB, wait on disk for the later checkouts
AB_DRAWS = 17


def batch_axis(key):
    """The batch axis of a saved field: the second of the state's (T, B,
    M), else the first."""
    return 1 if key in ("state_u", "state_z") else 0


def draw_block(key, x, i, B):
    """Draw i's block of a stacked field: rows i B .. (i + 1) B of its
    batch axis."""
    return x[(slice(None),) * batch_axis(key) + (slice(i * B, (i + 1) * B),)]


def float64_moves(x64, draws):
    """How far the float64 plain version itself moves when its inputs move
    by one float32 ulp: per field of ``x64`` (``draws`` stacked draws, the
    unperturbed first), for each perturbed draw i the largest
    ``|x64_i - x64_0|`` over the entries finite in both."""
    out = {}
    for key, x in x64.items():
        B = np.shape(x)[batch_axis(key)] // draws
        r = np.asarray(draw_block(key, x, 0, B), np.float64)
        moves = []
        for i in range(1, draws):
            m = np.asarray(draw_block(key, x, i, B), np.float64)
            fin = np.isfinite(r) & np.isfinite(m)
            moves.append(float(np.abs(m[fin] - r[fin]).max(initial=0.0)))
        out[key] = np.array(moves)
    return out


def field_bounds(x64, gmres=False):
    """b per field of one draw's float64 fields ``x64``: the absolute bound
    :func:`compare` applies to that field at the float64 field's scale
    (readouts READOUT_REL of scale, state the lesser of STATE_ATOL and
    STATE_REL of scale, F_H FORCE_REL of max(scale, 1), an excited string's
    zout ZOUT_REL of its scale, held at least ZOUT_FLOOR of uout's in a
    GMRES case)."""
    finite_max = lambda x: float(np.abs(x[np.isfinite(x)]).max(initial=0.0))
    excited = "v_r" in x64
    out = {}
    for key, x in x64.items():
        scale = finite_max(np.asarray(x))
        if key in STATE_FIELDS:
            out[key] = min(STATE_ATOL, STATE_REL * scale)
        elif key == "F_H":
            out[key] = FORCE_REL * max(scale, 1.0)
        elif key == "zout" and excited:
            floor = (ZOUT_FLOOR if gmres else 0.0) * finite_max(np.asarray(x64["uout"]))
            out[key] = ZOUT_REL * max(scale, floor)
        else:
            out[key] = READOUT_REL * scale
    return out


def string_errors(x64, got):
    """Per field of both ``x64`` and ``got``: each string's largest
    ``|got - x64|`` over the entries finite in both, and whether all of
    ``got``'s entries of that string are finite; taken 64 strings at a
    time, so that a stacked state field needs no whole-field temporaries."""
    out = {}
    for key in [key for key in x64 if key in got]:
        axis = batch_axis(key)
        n = np.shape(got[key])[axis]
        e, fin = np.zeros(n), np.ones(n, bool)
        for s0 in range(0, n, 64):
            rows = (slice(None),) * axis + (slice(s0, s0 + 64),)
            r, g = (np.moveaxis(np.asarray(d[key][rows], np.float64), axis, 0)
                    .reshape(min(64, n - s0), -1) for d in (x64, got))
            both = np.isfinite(r) & np.isfinite(g)
            e[s0:s0 + 64] = np.where(both, np.abs(g - r), 0.0).max(axis=1, initial=0.0)
            fin[s0:s0 + 64] = np.isfinite(g).all(axis=1)
        out[key] = (e, fin)
    return out


def draw_errors(e, keep, draws):
    """e per draw: the largest of its strings' errors ``e`` over those
    ``keep`` holds (0 where it holds none)."""
    return np.where(keep, e, 0.0).reshape(draws, -1).max(axis=1)


def draw_rule(e_first, e_later, b, moves=()):
    """``--ab --float64``'s rule for one field over the draws, which both
    checkouts ran on the same inputs: the later checkout passes if the
    median over the draws of how much further it lies than the first
    (``shift``, the median of ``e_later - e_first``) is at most the larger
    of b and float64's median move under the perturbations (``moves``).  A
    loss of accuracy larger than b on most draws moves that median by more
    than b; two equally accurate roundings, which one draw may part by more
    than b, differ by as much either way.  Paired, the median does not jump
    with the gaps between the draws' e, which exceed b where e lies far
    past it (PERF.md).  Returns the verdict (``ok``), ``b``, that ``move``,
    the ``shift``, both checkouts' unperturbed (first) draw's e (``e0``)
    and their medians, on how many draws the later lies further
    (``further`` of ``n``), the geometric mean of later / first over the
    draws where both are non-zero (``ratio``) with the standard error of
    its log (``se``), on how many draws each lies within b
    (``within_b``), and the draws' e (``e``)."""
    e_a, e_c = np.asarray(e_first, np.float64), np.asarray(e_later, np.float64)
    move = float(np.median(moves)) if len(moves) else 0.0
    shift = float(np.median(e_c - e_a))
    pos = (e_a > 0) & (e_c > 0)
    log = np.log(e_c[pos] / e_a[pos])
    return dict(ok=shift <= max(b, move), b=b, move=move, shift=shift,
                e0=(float(e_a[0]), float(e_c[0])),
                median=(float(np.median(e_a)), float(np.median(e_c))),
                further=int((e_c > e_a).sum()), n=len(e_a),
                ratio=float(np.exp(log.mean())) if len(log) else float("nan"),
                se=float(log.std(ddof=1) / np.sqrt(len(log))) if len(log) > 1 else float("nan"),
                within_b=(int((e_a <= b).sum()), int((e_c <= b).sum())), e=(e_a, e_c))


def float64_rule(bounds, moves, errs_first, errs_later, nan_first, nan_later, nan64, draws):
    """``--ab --float64``'s hold of one case over its ``draws`` stacked
    draws.  ``bounds`` maps each field to b (:func:`field_bounds`),
    ``moves`` to float64's move per perturbed draw (:func:`float64_moves`),
    ``errs_first`` and ``errs_later`` to each checkout's per-string errors
    (:func:`string_errors`); ``nan_*`` flag the strings whose uout has a
    NaN, in each checkout and in float64.  For each field a draw's e is its
    largest error over the strings finite in both checkouts (a string that
    one poisons drops out of both, and the poison rule counts it), and
    :func:`draw_rule` decides on the draws' e.  The case also fails if the
    later checkout poisons more strings than the first, over all draws,
    among those float64 keeps finite: where float64 poisons a string too,
    a poisoned result is float64's, and whether float32 poisons it as
    well is a matter of rounding (PERF.md).  Returns ``(ok, rows,
    poisoned)``: rows :func:`draw_rule`'s dicts with their ``field``,
    poisoned ``(draw, string, first, later, float64 finite)`` for each
    string whose status differs."""
    rows = []
    for key, b in bounds.items():
        if key in errs_first and key in errs_later:
            (e_a, f_a), (e_c, f_c) = errs_first[key], errs_later[key]
            rows.append(dict(field=key, **draw_rule(
                draw_errors(e_a, f_a & f_c, draws), draw_errors(e_c, f_a & f_c, draws),
                float(b), moves.get(key, ()))))
    B = len(nan_first) // draws
    poisoned = [(int(s) // B, int(s) % B, bool(nan_first[s]), bool(nan_later[s]),
                 not bool(nan64[s])) for s in np.nonzero(nan_first != nan_later)[0]]
    ok = (all(r["ok"] for r in rows)
          and int((nan_later & ~nan64).sum()) <= int((nan_first & ~nan64).sum()))
    return ok, rows, poisoned


def float64_case(x64, first, later, gmres=False, draws=1):
    """:func:`float64_rule` on whole fields: ``x64``, ``first`` and
    ``later`` map each saved field to its array over ``draws`` stacked
    draws (the unperturbed first), the float64 plain version's, the first
    checkout's and a later checkout's; b from the unperturbed float64
    draw, and float64's moves from its own draws."""
    B = np.shape(x64["uout"])[0] // draws
    nan = lambda d: np.isnan(np.asarray(d["uout"])).any(axis=1)
    bounds = field_bounds({key: draw_block(key, np.asarray(x), 0, B)
                           for key, x in x64.items()}, gmres)
    return float64_rule(bounds, float64_moves(x64, draws), string_errors(x64, first),
                        string_errors(x64, later), nan(first), nan(later), nan(x64), draws)


def ab_float64(roots, paths):
    """Every later checkout's draws held to the float64 plain version of
    the first checkout's process by :func:`float64_rule`, case by case;
    per field printed: the unperturbed e of both checkouts, both medians
    over the draws, b and float64's median move, on how many draws the
    later lies further, the paired geometric-mean ratio with the standard
    error of its log, and on how many draws each lies within b; and each
    string poisoned on one side only.  Returns False if a case fails."""
    ref = np.load(paths[0])
    if not any(key.startswith("b/") for key in ref.files):
        print(f"[ab] {roots[0]}: no float64 fields")
        return False
    pick = lambda data, prefix: {key[len(prefix):]: data[key] for key in data.files
                                 if key.startswith(prefix)}
    ok = True
    for root, path in zip(roots[1:], paths[1:]):
        got = np.load(path)
        for tag, _, _, _ in AB_CASES:
            errs = lambda data: {key: (e, data[f"fin/{tag}/{key}"])
                                 for key, e in pick(data, f"e/{tag}/").items()}
            nan_a, nan_c, nan64 = ref[f"nan/{tag}"], got[f"nan/{tag}"], ref[f"nan64/{tag}"]
            case_ok, rows, poisoned = float64_rule(
                pick(ref, f"b/{tag}/"), pick(ref, f"move/{tag}/"), errs(ref), errs(got),
                nan_a, nan_c, nan64, AB_DRAWS)
            print(f"[ab] {root} ({tag}) from float64 over {AB_DRAWS} draws "
                  f"{'held' if case_ok else 'FAILS'}: poisoned strings {int(nan_a.sum())} -> "
                  f"{int(nan_c.sum())}, of those float64 keeps finite "
                  f"{int((nan_a & ~nan64).sum())} -> {int((nan_c & ~nan64).sum())}")
            for r in rows:
                print(f"[ab]     ({tag}) {r['field']}: unperturbed {r['e0'][0]:.3e} -> "
                      f"{r['e0'][1]:.3e}, median {r['median'][0]:.3e} -> {r['median'][1]:.3e}, "
                      f"later further by {r['shift']:.3e} in the median draw (b {r['b']:.3e}, "
                      f"float64's median move {r['move']:.3e}){'' if r['ok'] else ': over'}; "
                      f"later further on {r['further']}/{r['n']}, geometric mean of "
                      f"later/first {r['ratio']:.3f} (standard error of its log "
                      f"{r['se']:.3f}); within b on {r['within_b'][0]}/{r['n']} -> "
                      f"{r['within_b'][1]}/{r['n']}")
                print(f"[ab]         e per draw: " + " ".join(f"{x:.3e}" for x in r["e"][0])
                      + " -> " + " ".join(f"{x:.3e}" for x in r["e"][1]))
            for d, s, p_a, p_c, fin64 in poisoned:
                print(f"[ab]     ({tag}) draw {d} string {s}: poisoned {p_a} -> {p_c}, "
                      f"float64 {'finite' if fin64 else 'poisoned'}")
            ok = ok and case_ok
    return ok


def speed_rule(roots, times):
    """``--ab``'s speed rule over the checkouts ``roots``, in their turns,
    and each turn's times (ms per 256 steps by case): the mean of each of
    AB_SPEED_CASES per distinct checkout (one given twice, as in old, new,
    new, old, averages its turns), and per later checkout the cases on
    which its mean exceeds the first checkout's by more than
    AB_SPEED_ALLOWANCE of it.  Returns ``(mean, slower)``, each by
    checkout."""
    runs = {}
    for root, t in zip(roots, times):
        runs.setdefault(root, []).append(t)
    mean = {root: {tag: float(np.mean([t[tag] for t in ts])) for tag in AB_SPEED_CASES}
            for root, ts in runs.items()}
    first = mean[roots[0]]
    slower = {root: [tag for tag in AB_SPEED_CASES
                     if m[tag] > first[tag] * (1 + AB_SPEED_ALLOWANCE)]
              for root, m in mean.items() if root != roots[0]}
    return mean, slower


def ab_speed(roots, paths):
    """:func:`speed_rule` on the saved times: per later checkout its mean
    of each case against the first's, the allowance and the cases it is
    slower on.  Returns False if a later checkout is slower on any."""
    mean, slower = speed_rule(roots, [json.loads(str(np.load(path)["times"]))
                                      for path in paths])
    first = mean[roots[0]]
    for root, tags in slower.items():
        m = mean[root]
        print(f"[ab] speed {root} against {roots[0]}, mean ms per 256 steps: "
              + ", ".join(f"({tag}) {first[tag]:.3f} -> {m[tag]:.3f} "
                          f"({100 * (m[tag] / first[tag] - 1):+.3f}%)"
                          for tag in AB_SPEED_CASES)
              + f"; allowance +{100 * AB_SPEED_ALLOWANCE:.3f}%"
              + (f"; slower past it on {tags}" if tags else ""))
    return not any(slower.values())


def sharded_only(dev, card, t_start):
    """``--sharded``: after phases 1-2, phase 9's fused run and phase 18's
    corpus, what phase 20 compares with, then phase 20 (with (d) on a host
    of two cards or more)."""
    from torch_fdtd_string_tpu_torch.core import analytic

    analytic.root_tables()
    head = drive_fused(9, "nsynth-like (fused preprocessing, the default)", FUSED,
                       PREP_KEYS, 256, card)
    corpus = drive_fused(18, "corpus recipe B=48, two batches (seed 1818)", TRAIN_CORPUS,
                         PREP_KEYS_CORPUS, 8, card)
    prep_dir = corpus["save_dir"] + "-prep"
    train_corpus_split(prep_dir)
    over = DMSP_TRAIN + [f"task.load_dir={os.path.dirname(prep_dir)}",
                         f"task.load_name={os.path.basename(prep_dir)}"]
    drive_phase20(head["save_dir"], None, over, dev, card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase3(dev, card):
    """Phase 3: every instance against its plain version on the card, each
    specialization's shapes, the bucketed launch, the GMRES instances and
    the ladder's re-run, the MMS forcing, the fixed schedule and
    ``pluck_chunked``.  Returns the JSON records of the instances, by
    specialization: ``(record, gm_record)``."""
    from torch_fdtd_string_tpu_torch.ops import string_kernel as sk

    shape_b = nsynth_inputs(NSYNTH, dev)
    shape_c = nsynth_inputs(NSYNTH + BOW16, dev)
    record = {}
    for spec, tag, inputs in (
        ("pluck", "(a) B=4 bench draw", bench_inputs(4, 0.02, 7, dev)),
        ("pluck", "(b) nsynth-like B=24", shape_b),
        ("bow", "(c) bowed B=16", shape_c),
        ("hammer", "(d) hammered B=24", nsynth_inputs(NSYNTH + HAMMER, dev)),
        ("mix", "(e) model.excitation=null B=24", nsynth_inputs(NSYNTH + MIX, dev)),
        ("pluck-pickup", "(f) B=4 bench draw, pickup readout",
         bench_inputs(4, 0.02, 7, dev, surface_integral=False)),
        ("bow-pickup", "(g) bowed B=16, pickup readout",
         nsynth_inputs(NSYNTH + BOW16 + PICKUP, dev)),
        ("hammer-pickup", "(h) hammered B=24, pickup readout",
         nsynth_inputs(NSYNTH + HAMMER + PICKUP, dev)),
        ("mix-pickup", "(i) model.excitation=null B=24, pickup readout",
         nsynth_inputs(NSYNTH + MIX + PICKUP, dev)),
        ("pluck-pickup", "(j) phase 8's first batch, B=4", nsynth_inputs(PICKUP4, dev)),
    ):
        args, kwargs = truncate(inputs, 256)
        B, M_t, M_l = args[0].shape[0], kwargs["M_t"], kwargs["M_l"]
        print(f"[3] {tag}: B={B}, M_t={M_t}, M_l={M_l}, T=256")
        got = sk.string_chunked(*args, **kwargs)
        ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kwargs))
        worst = compare(tag, got, ref)
        ms = cuda_ms(lambda: sk.string_chunked(*args, **kwargs), reps=10)
        bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"])
        print(f"[3] {tag}: per 256 steps kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
        # the JSON record keeps the last shape of each specialization
        record[spec] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    args, kwargs = truncate(shape_b, DIVERGENCE_STEPS)
    g = sk.string_chunked(*args, **kwargs)[2]["state_u"]
    r = sk.string_chunked_reference(*args, **kwargs)[2]["state_u"]
    fin = ~torch.isnan(r)
    div = float((g[fin] - r[fin]).abs().max() / r[fin].abs().max())
    print(f"[3] (b) after {DIVERGENCE_STEPS} steps: max |kernel - plain| / max|plain| of "
          f"state_u = {div:.3e} (recorded, not asserted)")

    # the width-bucketed launch: against its plain version and the unbucketed
    # kernel, per group and whole
    shape_k = nsynth_inputs(FUSED, dev)
    shape_l = nsynth_inputs(CORPUS48, dev)
    for tag, inputs in (("(k) nsynth-like B=24", shape_k),
                        ("(l) corpus recipe B=48", shape_l),
                        ("(m) model.excitation=null B=48", nsynth_inputs(CORPUS48 + MIX, dev))):
        args, kwargs = truncate(inputs, 256)
        hb = host_bounds(args)
        rest = {key: v for key, v in kwargs.items() if key not in ("M_t", "M_l")}
        groups = sk.bucket_groups(*hb, k=kwargs["k"], theta_t=kwargs["theta_t"],
                                  lambda_c=kwargs["lambda_c"], M_t=kwargs["M_t"],
                                  M_l=kwargs["M_l"])
        W = sk.padded_width(kwargs["M_t"], kwargs["M_l"])
        print(f"[3] {tag}: B={args[0].shape[0]}, M_t={kwargs['M_t']}, "
              f"M_l={kwargs['M_l']}, unbucketed width {W}, groups "
              f"{[(w, len(rows)) for w, rows in groups]}, T=256")
        bucketed = lambda: sk.string_chunked_bucketed(*args, host_bounds=hb, **kwargs)
        got = bucketed()
        ref, plain_ms = timed_once(
            lambda: sk.string_chunked_bucketed_reference(*args, host_bounds=hb, **kwargs))
        worst = compare(tag, got, ref)
        compare(f"{tag} vs unbucketed kernel", got,
                within_groups(sk.string_chunked(*args, **kwargs), groups))
        ms = cuda_ms(bucketed, reps=10)
        flat_ms = cuda_ms(lambda: sk.string_chunked(*args, **kwargs), reps=10)
        # one group alone, at its width and at the unbucketed width (the
        # launcher's internals: no public call runs a single group)
        c = sk._consts(M_t=kwargs["M_t"], M_l=kwargs["M_l"], M_t_sem=None,
                       **sk._kernel_kw(rest))
        for w, rows in groups:
            g_ms, g_flat_ms = (cuda_ms(lambda: sk._launch_cuda(
                c, *args, kwargs.get("bow"), kwargs.get("hammer"),
                groups=[(width, rows)]), reps=5) for width in (w, W))
            print(f"[3] {tag}: group width {w}, {len(rows)} strings alone: "
                  f"{g_ms:.3f} ms per 256 steps, {g_flat_ms:.3f} ms at width {W} "
                  f"[{card}]")
        bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"])
        print(f"[3] {tag}: per 256 steps bucketed {ms:.3f} ms, unbucketed "
              f"{flat_ms:.3f} ms, plain (bucketed) {plain_ms:.1f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
        if tag.startswith("(k)"):
            record["bucketed"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)

    # the GMRES instances against their plain version; the JSON record holds
    # the re-runs of (q) and (r), the main path's shapes
    gm_record = {}
    for tag, inputs, over in (
        ("(n) B=4 bench draw, coupling_iters=1",
         bench_inputs(4, 0.02, 7, dev), dict(coupling_iters=1)),
        ("(o) strong coupling alpha=23 f0=392, cap 24",
         strong_inputs(256, dev), {}),
        ("(p) model.excitation=null B=24, coupling_iters=1",
         nsynth_inputs(NSYNTH + MIX, dev), dict(coupling_iters=1)),
    ):
        args, kwargs = truncate(inputs, 256)
        kwargs = dict(kwargs, gmres_rescue=True, **over)
        print(f"[3] {tag}: B={args[0].shape[0]}, M_t={kwargs['M_t']}, "
              f"M_l={kwargs['M_l']}, T=256, GMRES instance")
        got = sk.string_chunked(*args, **kwargs)
        ref, plain_ms = timed_once(lambda: sk.string_chunked_reference(*args, **kwargs))
        compare(tag, got, ref, zout_floor=ZOUT_FLOOR)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[2]["state_u"]).all()):
            raise AssertionError(f"[3] {tag}: not finite")
        ms = cuda_ms(lambda: sk.string_chunked(*args, **kwargs), reps=3)
        iters = ref[2]["gmres_iters"]
        bound_ms, bound_by = bound(args, kwargs, ref[2]["sweeps"], iters)
        rescued = iters > 0
        print(f"[3] {tag}: per 256 steps kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}); string-steps through GMRES "
              f"{int(rescued.sum())} of {rescued.numel()}, mean Arnoldi iterations "
              f"{float(iters[rescued].float().mean()) if rescued.any() else 0.0:.2f} "
              f"[{card}]")

    # (q), (r) the re-run as the ladder launches it: the first pass's NaN
    # rows of phase 11's and phase 12's draws
    for tag, inputs in (("(q) phase 11's draw, corpus recipe B=48", shape_l),
                        ("(r) phase 12's draw, model.excitation=null B=24",
                         nsynth_inputs(LADDER_CLASSIC, dev))):
        spec, gm_record[spec] = check_rerun(tag, inputs, dev, card)

    # (s)-(u): the MMS forcing, the fixed schedule, pluck_chunked.  The MMS
    # records are of the verification runs' own draws; pluck-gmres's is (u)'s
    # rather than (q)'s: phases 15 and 16 launch it on the bench workload,
    # far more often than phase 11's re-run
    check_mms(dev, card)
    record["pluck-mms"], gm_record["pluck-mms-gmres"] = check_verification_draws(dev, card)
    record["pluck-fixed"] = check_fixed(
        [("draw (a)", bench_inputs(4, 0.02, 7, dev), "float64"),
         ("the JAX test's draw, seed 11", bench_inputs(4, 0.02, 11, dev), "twin"),
         ("draw (b)", shape_b, None)], card)
    gm_record["pluck-gmres"] = check_pluck_chunked(bench_inputs(4, 0.02, 7, dev), card)
    return record, gm_record


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"]:
        return rank_worker(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--deterministic-step"]:
        return deterministic_step(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-one"]:
        # --ab-one ROOT OUT [--float64 DRAWS_DIR [--reference]]
        draws_dir = sys.argv[5] if sys.argv[4:5] == ["--float64"] else None
        ab_times(os.path.abspath(sys.argv[2]), sys.argv[3], draws_dir,
                 sys.argv[6:7] == ["--reference"])
        return 0
    if sys.argv[1:2] == ["--ab"]:
        import tempfile

        float64 = sys.argv[2:3] == ["--float64"]
        roots = [os.path.abspath(r) for r in sys.argv[3 if float64 else 2:]]
        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, f"ab{n}.npz") for n in range(len(roots))]
            for n, (root, path) in enumerate(zip(roots, paths)):
                # this file by path, so that each checkout's own package is
                # imported, and its draws are this file's; a failed build or
                # launch fails the whole call
                draws = ["--float64", tmp] + (["--reference"] if n == 0 else [])
                subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-one",
                                root, path] + (draws if float64 else []),
                               check=True, cwd=root)
            spills = ab_ptxas(roots, paths)
            if float64:
                held, faster = ab_float64(roots, paths), ab_speed(roots, paths)
            else:  # the speed rule's reading, printed, not decided on (PERF.md)
                held, faster = ab_compare(roots, paths), True
                ab_speed(roots, paths)
            if not held:
                print("[ab] the checkouts' outputs differ"
                      + (" from float64 further than the first's in the median draw by "
                         "more than the f32 bound, or poison more strings" if float64 else ""),
                      file=sys.stderr)
                return 1
            if not spills:
                print("[ab] an instance spills more than in the first checkout",
                      file=sys.stderr)
                return 1
            if not faster:
                print(f"[ab] a checkout is slower than the first on one of "
                      f"{AB_SPEED_CASES}", file=sys.stderr)
                return 1
        print("[ab] every saved output " + (
            f"as near float64 as the first checkout's in the median of {AB_DRAWS} draws, "
            "within the f32 bounds, no more strings poisoned, no slower" if float64
            else "equal bit for bit across the checkouts"))
        return 0
    from torch_fdtd_string_tpu_torch.ops import build
    from torch_fdtd_string_tpu_torch.ops.string_kernel import (
        string_chunked,
        string_chunked_bucketed,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--phase3-plain"]:
        torch.set_num_threads(1)  # the main process's CPU phases run beside it
        with PlainCalls("record", sys.argv[2]) as calls:
            phase3(dev, smi())
        print(f"[3] {calls.n} plain calls recorded in {time.perf_counter() - t_start:.1f} s")
        return 0

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
    ptxas = ptxas_report(build.build_log.get("string_step", ""))
    print(f"[2] {len(ptxas)} instances compiled; ptxas report:")
    for name, lines in ptxas.items():
        print(f"[2]   {name}: {' | '.join(lines)}")

    if sys.argv[1:2] == ["--sharded"]:
        return sharded_only(dev, card, t_start)

    # ---- 3. (its plain versions: a child process beside phases 4-18) ------------
    plain = PlainChild()

    # ---- 4-8. the classic paths -------------------------------------------------
    launches = {}
    launches["pluck"], pluck = drive(4, "nsynth-like, plucked", NSYNTH, "pluck", card)
    if pluck["pitched"] < 1:
        raise AssertionError("no item's spectral peak is within 3% of target_f0")

    launches["mix"], mix = drive(5, "nsynth-like, model.excitation=null",
                                 NSYNTH + MIX, "mix", card)
    missing = {"bow", "hammer", "pluck"} - set(mix["kinds"])
    if missing:
        raise AssertionError(f"[5] no written item of kind {sorted(missing)}")

    launches["bow"], bow = drive(6, "bowed B=16 (bench bow_b16 shape)",
                                 NSYNTH + BOW16, "bow", card)
    print(f"[6] bowed B=16, 1 s: {bow['audio_s'] / bow['wall']:.2f} audio-s/s "
          f"end to end [{card}]")
    launches["hammer"], _ = drive(7, "nsynth-like, model.excitation=hammer",
                                  NSYNTH + HAMMER, "hammer", card)
    launches["pluck-pickup"], _ = drive(8, "nsynth-like, pickup readout", PICKUP4,
                                        "pluck-pickup", card)

    # ---- 9. the headline: fused preprocessing -----------------------------------
    # the modal solution's root table, built on first use in a checkout; built
    # here so that the headline's wall shows a run with the table in place
    from torch_fdtd_string_tpu_torch.core import analytic

    t0 = time.perf_counter()
    analytic.root_tables()
    print(f"[9] root table ready in {time.perf_counter() - t0:.2f} s (sweep build "
          f"{analytic.table_build_seconds.get(257, 0.0):.2f} s) [{card}]")
    head = drive_fused(9, "nsynth-like (fused preprocessing, the default)", FUSED,
                       PREP_KEYS, 256, card)
    launches["bucketed"] = head["launches"]
    check_host_build(*nsynth_inputs(FUSED, dev), head["save_dir"] + "-prep", head["items"],
                     head["task"], card)

    # ---- 10. the corpus recipe at B=48 ------------------------------------------
    corpus = drive_fused(10, "corpus recipe B=48", CORPUS48, PREP_KEYS_CORPUS, 8, card)
    if corpus["run_items"]:
        raise AssertionError(f"[10] run-dir items written: {corpus['run_items'][:3]}")
    if corpus["launches"] < 2:
        raise AssertionError(f"[10] {corpus['launches']} bucket group(s), not 2 or more")
    print(f"[10] corpus recipe B=48: {corpus['audio_s'] / corpus['wall']:.2f} "
          f"audio-s/s end to end [{card}]")
    print(f"[10] done at {time.perf_counter() - t_start:.1f} s")
    plain.check()

    # ---- 13-16. the verification and the timing paths ------------------------
    gm_launches = {}
    launches["pluck-mms"], lin = drive(13, "experiment=linear-string, single precision",
                                       LINEAR, "pluck-mms", card)
    check_mms_run(lin, card)
    add_gmres(gm_launches, lin["by_spec"])
    _, nonlin = drive(14, "experiment=nonlinear-string, single precision", NONLINEAR,
                      "pluck", card)
    add_gmres(gm_launches, nonlin["by_spec"])
    launches["pluck-fixed"], by_spec = drive_kernel_timing(dev, card)
    add_gmres(gm_launches, by_spec)
    add_gmres(gm_launches, drive_time_experiment(dev, card))
    print(f"[16] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 17. the DMSP serving path on phase 10's corpus; float64 on the card ---
    drive_dmsp(corpus["save_dir"] + "-prep", dev, card)
    print(f"[17] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 18. DMSP training at full width on a fresh corpus ----------------------
    plain.check()
    train = drive_dmsp_train(dev, card)
    print(f"[18] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3. every instance against its plain version, the card to itself --------
    print(plain.wait())
    with PlainCalls("replay", plain.path) as calls:
        record, gm_record = phase3(dev, card)
    if calls.n != calls.saved():
        raise AssertionError(f"[3] {calls.n} plain calls, {calls.saved()} recorded")
    shutil.rmtree(plain.path)
    print(f"[3] done at {time.perf_counter() - t_start:.1f} s")
    # phase 4's shapes through the kernel alone, at their whole length
    for tag, overrides in (("pluck B=24", NSYNTH), ("bow B=16", NSYNTH + BOW16),
                           ("corpus B=48", CORPUS48)):
        args, kwargs = nsynth_inputs(overrides, dev)
        B, T = args[0].shape
        hb = host_bounds(args)
        flat_ms = cuda_ms(lambda: string_chunked(*args, **kwargs), reps=1)
        ms = cuda_ms(lambda: string_chunked_bucketed(*args, host_bounds=hb, **kwargs),
                     reps=1)
        print(f"[4] {tag} kernel alone at T={T}: unbucketed {flat_ms:.1f} ms, "
              f"bucketed {ms:.1f} ms = {B / (ms / 1e3):.1f} audio-s/s, "
              f"{B * T / (ms / 1e3):.4g} string-steps/s [{card}]")

    # ---- 19. the classic pipeline on phase 4's run; presets ---------------------
    for spec, n in drive_phase19(pluck, head["save_dir"] + "-prep", dev, card).items():
        launches[spec] += n
    print(f"[19] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 20. the sharded paths: two ranks on the card, NCCL ----------------------
    launches["bucketed"] += drive_phase20(head["save_dir"], pluck["save_dir"], train["over"],
                                          dev, card)
    print(f"[20] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 21. the figures and a JAX run on the card's host ----------------------
    drive_phase21(train["over"] + ["proc.train=false"], card)
    print(f"[21] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 22. the port alone; the profiling scopes; the tools -------------------
    n, by_spec = drive_phase22(train["over"], dev, card)
    launches["bucketed"] += n
    add_gmres(gm_launches, by_spec)
    print(f"[22] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 11-12. the rescue ladder ----------------------------------------------
    length = ladder_length(11, LADDER_FUSED, dev, card)
    lad = drive_fused(11, "rescue ladder, corpus recipe B=48 (fused)",
                      LADDER_FUSED + [f"task.length={length}"], PREP_KEYS_CORPUS, 8, card)
    check_ladder(11, lad["stats"]["batches"], lad["task"], lad["wall"], card,
                 need_nan=True)
    add_gmres(gm_launches, lad["by_spec"])

    length = ladder_length(12, LADDER_CLASSIC, dev, card)
    _, lad = drive(12, "rescue ladder, model.excitation=null B=24 (classic)",
                   LADDER_CLASSIC + [f"task.length={length}"], "mix", card)
    check_ladder(12, lad["stats"], lad["task"], lad["wall"], card, need_nan=True)
    for b in lad["stats"]:
        for r in b.get("rescue_f64_rows", []):
            z = np.load(os.path.join(lad["save_dir"], f"{b['it']}-{r}", "simulation.npz"))
            if not all(np.isfinite(z[key]).all() for key in FIELDS):
                raise AssertionError(f"[12] spliced item {b['it']}-{r} not finite")
            print(f"[12] spliced item {b['it']}-{r}: every field of simulation.npz finite")
    add_gmres(gm_launches, lad["by_spec"])
    if not gm_launches:
        raise AssertionError("[11-12] no GMRES instance launched")
    missing = set(gm_launches) - set(gm_record)
    if missing:
        raise AssertionError(f"[11-12] GMRES instances without a phase-3 record: {missing}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [dict(
        name=f"string_step[{spec}]", route="cuda",
        source=KERNEL_SRC, replaces=REPLACES[spec], launches=launches[spec],
        **record[spec],
    ) for spec in REPLACES] + [dict(
        name=f"string_step[{spec}]", route="cuda", source=KERNEL_SRC,
        replaces=GMRES_REPLACES, launches=n, **gm_record[spec],
    ) for spec, n in sorted(gm_launches.items())]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
