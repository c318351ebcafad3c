"""Convert a JAX training run's orbax checkpoints into the port's format.

    python -m torch_fdtd_string_tpu_torch.tools.convert_orbax <jax run dir> <out run dir> \\
        [overrides ...]

The JAX package's ``tasks/trainer.py::save_checkpoint`` writes each
checkpoint as an orbax directory ``step_<n>/``; reading one needs
tensorstore, which a card's host may lack.  On a host that has it, this
tool reads every ``step_<n>/`` of the run (``models/convert.py::load_orbax``),
carries it into the port's ``Synthesizer`` built from the overrides (the
run's own ``experiment=`` and ``model.*`` settings; a shape or a leaf that
does not fit raises) and writes ``<out run dir>/string/ckpt/checkpoints/
step_<n>.pt`` (``params``, ``constants``, ``step``: the port's checkpoint),
with the run's ``BEST`` marker beside them.  Then ``proc.test
task.ckpt_dir=<out run dir>`` scores the JAX-trained model on any host.
The optimizer state (``optstate_<n>/``) is not converted: a converted run
is scored, not resumed.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys

from ..models.convert import load_orbax, state_dict_from_jax
from ..run import CONFIG_DIR
from ..tasks import synthesize as S
from ..tasks.trainer import _ckpt_dir, _is_checkpoint, _step, save_checkpoint
from ..utils.config import compose


def convert_run(jax_run_dir, out_run_dir, overrides=()):
    """Write the port's ``step_<n>.pt`` for every orbax checkpoint of
    ``jax_run_dir`` (either run layout) under ``out_run_dir``, and copy its
    ``BEST``.  Returns the paths written."""
    args = compose(CONFIG_DIR, list(overrides))
    model = S.build_model(args)
    written = []
    for layout in ("string/*/checkpoints", "checkpoints"):
        for ckpt_dir in sorted(glob.glob(os.path.join(jax_run_dir, layout))):
            steps = [p for p in glob.glob(os.path.join(ckpt_dir, "step_*"))
                     if os.path.isdir(p) and _is_checkpoint(p)]
            for path in sorted(steps, key=_step):
                model.load_state_dict(state_dict_from_jax(model, load_orbax(path)), strict=True)
                written.append(save_checkpoint(out_run_dir, model, _step(path)))
                print(f"[convert_orbax] {path} -> {written[-1]}", flush=True)
            best = os.path.join(ckpt_dir, "BEST")
            if os.path.isfile(best):
                shutil.copyfile(best, os.path.join(_ckpt_dir(out_run_dir), "BEST"))
    if not written:
        raise FileNotFoundError(f"no orbax checkpoint step_<n>/ under {jax_run_dir}")
    return written


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.exit(__doc__)
    convert_run(argv[0], argv[1], argv[2:])


if __name__ == "__main__":
    main()
