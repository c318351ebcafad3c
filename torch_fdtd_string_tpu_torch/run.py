"""CLI entry point of the PyTorch port.

    python -m torch_fdtd_string_tpu_torch.run experiment=nsynth-like \\
        task.num_samples=24

Takes the same overrides as the JAX package's ``run.py`` and composes its
own copy of the same config tree (``configs/`` in this package, read as
YAML by file path), so that the package runs without the JAX package
beside it; ``backup_code`` snapshots that tree with the code.  Every
``proc.*`` branch is ported, in the JAX package's order: ``proc.simulate``
(dataset generation, presets with ``task.load_config=<dir>``),
``proc.evaluate`` and ``proc.summarize`` (the f0 scores of a simulation
run, host numpy), ``proc.process_training_data`` (a classic run into the
DMSP layout), ``proc.train`` (the DMSP synthesizer's training) and
``proc.test`` (its scoring of a test split).
The simulation, the preprocessing's modal bank, training and scoring run
on the card unless ``proc.cpu=true``.

On several cards, one process (rank) per card:

    torchrun --nproc_per_node=N -m torch_fdtd_string_tpu_torch.run \\
        experiment=nsynth-like task.num_samples=96

``proc.simulate`` and ``proc.train`` shard each batch over the ranks
(``parallel/mesh.py``; ``task.batch_size`` must divide by N); rank 0 alone
prints the config, writes the run directory's ``config_tree.txt`` and
``codes/`` snapshot, and runs ``proc.evaluate``, ``proc.summarize``,
``proc.process_training_data`` and ``proc.test``.  Across hosts, set
``FDTD_COORD=host:port``, ``FDTD_NPROCS`` and ``FDTD_PROC_ID`` (with
``LOCAL_RANK``) in each process instead.

    python -m torch_fdtd_string_tpu_torch.run experiment=process_training_data \\
        task.result_dir=<simulation run> task.save_dir=<prepared dir>
    python -m torch_fdtd_string_tpu_torch.run experiment=evaluate task.load_dir=<run>
    python -m torch_fdtd_string_tpu_torch.run proc.simulate=false \\
        proc.summarize=true task.load_dir=<run>
    python -m torch_fdtd_string_tpu_torch.run experiment=synth-dmsp \\
        proc.train=true proc.test=true task.plot=false \\
        task.load_dir=results task.load_name=<corpus> task.save_name=<run>
"""

from __future__ import annotations

import os
import sys
from shutil import copyfile

import numpy as np

import torch

from torch_fdtd_string_tpu_torch.parallel import mesh
from torch_fdtd_string_tpu_torch.tasks import (evaluate, process_training_data,
                                               simulate, summarize, trainer)
from torch_fdtd_string_tpu_torch.utils.config import compose, print_config

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
CONFIG_DIR = os.path.join(PKG_DIR, "configs")


def backup_code(src_dir, run_dir):
    """Snapshot the port's package into ``<run_dir>/codes/<package>``
    (reference run.py:30-52), so a run records the code and the config
    tree (``configs/``) that produced it."""
    exclude_dir = {"__pycache__", "build"}
    exclude_ext = {".png", ".jpg", ".pt", ".npz", ".ckpt", ".wav", ".so"}
    dst_root = os.path.join(run_dir, "codes", os.path.basename(src_dir))
    for dirpath, dirnames, filenames in os.walk(src_dir, topdown=True):
        dirnames[:] = [d for d in dirnames if d not in exclude_dir]
        dst_dir = os.path.join(dst_root, os.path.relpath(dirpath, src_dir))
        os.makedirs(dst_dir, exist_ok=True)
        for name in filenames:
            if os.path.splitext(name)[-1] in exclude_ext or name.endswith(".swp"):
                continue
            copyfile(os.path.join(dirpath, name), os.path.join(dst_dir, name))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = compose(CONFIG_DIR, argv)
    # several ranks (torchrun, or FDTD_COORD / FDTD_NPROCS / FDTD_PROC_ID):
    # join their group before anything touches the card (JAX run.py:63-71)
    owned = not torch.distributed.is_initialized()
    if mesh.init_distributed(cpu=bool(args.proc.cpu)):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[run] distributed: process {mesh.rank()}/{mesh.world_size()}, "
              f"{torch.distributed.get_backend()} on {mesh.local_device(args.proc.cpu)}, "
              f"{cards} local card(s)", flush=True)
    try:
        return _main(args)
    finally:
        if owned:
            mesh.destroy()


def _main(args):
    np.random.seed(args.proc.seed)
    lead = mesh.rank() == 0

    args.cwd = ROOT
    if args.task.save_name is not None:
        save_dir_name = args.task.save_name
    elif args.proc.debug or args.task.result_dir == "debug":
        args.proc.debug = True
        save_dir_name = "debug"
    else:
        save_dir_name = args.task.result_dir
    if not os.path.isabs(args.task.root_dir):
        args.task.root_dir = os.path.join(ROOT, args.task.root_dir)
    if args.task.get("load_dir") and not os.path.isabs(args.task.load_dir):
        args.task.load_dir = os.path.join(ROOT, args.task.load_dir)
    save_dir = f"{args.task.root_dir}/{save_dir_name}"

    if args.task.measure_time:
        args.task.plot = False
        args.task.save = False
        args.task.plot_state = False

    # a training run scores its own checkpoints (JAX run.py:146)
    if args.proc.get("train") and args.proc.get("test") and args.task.get("ckpt_dir") is not None:
        raise ValueError("task.ckpt_dir names another run's checkpoints; it cannot be given "
                         "with proc.train=true proc.test=true")

    if lead and (args.proc.simulate or args.proc.get("train")):
        os.makedirs(save_dir, exist_ok=True)
        backup_code(PKG_DIR, save_dir)
        print_config(args, os.path.join(save_dir, "config_tree.txt"))
    elif lead:
        print_config(args)
    mesh.barrier()  # the run directory exists before any rank writes there

    if args.proc.simulate:
        model_name = (
            "random" if args.model.get("excitation") is None else args.model.excitation
        )
        n_samples = max(args.task.num_samples // args.task.batch_size, 1)
        simulate.run(args, save_dir, model_name, n_samples=n_samples)

    load_dir = save_dir if args.task.get("load_dir") is None else args.task.load_dir
    single = [name for name in ("evaluate", "summarize", "process_training_data")
              if args.proc.get(name)]
    if single and mesh.world_size() > 1 and lead:
        print(f"[run] proc.{', proc.'.join(single)} on rank 0 alone", flush=True)
    if args.proc.evaluate and lead:
        evaluate.evaluate(load_dir, plot=args.task.get("plot", False))

    if args.proc.summarize and lead:
        summarize.summarize(load_dir)

    if args.proc.process_training_data and lead:
        process_training_data.process(args)
    mesh.barrier()  # the prepared items exist before any rank trains on them

    if args.proc.get("train"):
        trainer.train(args, save_dir)

    if args.proc.get("test") and lead:
        if mesh.world_size() > 1:
            print("[run] proc.test on rank 0 alone", flush=True)
        args.task.ckpt_dir = args.task.get("ckpt_dir") or save_dir
        trainer.evaluate(args, save_dir)
    return save_dir


if __name__ == "__main__":
    main()
