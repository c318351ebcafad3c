"""CLI entry point of the PyTorch port.

    python -m torch_fdtd_string_tpu_torch.run experiment=nsynth-like \\
        task.num_samples=24

Takes the same overrides as the JAX package's ``run.py`` and composes the
same config tree (``torch_fdtd_string_tpu/configs``, read as YAML by file
path).  Every ``proc.*`` branch is ported, in the JAX package's order:
``proc.simulate`` (dataset generation, presets with
``task.load_config=<dir>``), ``proc.evaluate`` and ``proc.summarize`` (the
f0 scores of a simulation run, host numpy), ``proc.process_training_data``
(a classic run into the DMSP layout), ``proc.train`` (the DMSP
synthesizer's training) and ``proc.test`` (its scoring of a test split).
The simulation, the preprocessing's modal bank, training and scoring run
on the card unless ``proc.cpu=true``.

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

from torch_fdtd_string_tpu_torch.tasks import (evaluate, process_training_data,
                                               simulate, summarize, trainer)
from torch_fdtd_string_tpu_torch.utils.config import compose, print_config

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
CONFIG_DIR = os.path.join(ROOT, "torch_fdtd_string_tpu", "configs")


def backup_code(src_dir, run_dir):
    """Snapshot the port's package into ``<run_dir>/codes/<package>``
    (reference run.py:30-52), so a run records the code that produced it."""
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
    np.random.seed(args.proc.seed)

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

    if args.proc.simulate or args.proc.get("train"):
        os.makedirs(save_dir, exist_ok=True)
        backup_code(PKG_DIR, save_dir)
        print_config(args, os.path.join(save_dir, "config_tree.txt"))
    else:
        print_config(args)

    if args.proc.simulate:
        model_name = (
            "random" if args.model.get("excitation") is None else args.model.excitation
        )
        n_samples = max(args.task.num_samples // args.task.batch_size, 1)
        simulate.run(args, save_dir, model_name, n_samples=n_samples)

    load_dir = save_dir if args.task.get("load_dir") is None else args.task.load_dir
    if args.proc.evaluate:
        evaluate.evaluate(load_dir, plot=args.task.get("plot", False))

    if args.proc.summarize:
        summarize.summarize(load_dir)

    if args.proc.process_training_data:
        process_training_data.process(args)

    if args.proc.get("train"):
        trainer.train(args, save_dir)

    if args.proc.get("test"):
        args.task.ckpt_dir = args.task.get("ckpt_dir") or save_dir
        trainer.evaluate(args, save_dir)
    return save_dir


if __name__ == "__main__":
    main()
