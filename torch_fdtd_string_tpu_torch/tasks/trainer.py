"""Evaluation harness of the DMSP synthesizer: checkpoints, the test loop,
JSONL metric logging and the score tables.

Port of the inference half of ``torch_fdtd_string_tpu/tasks/trainer.py``
(reference ``src/trainer.py`` + ``src/callbacks.py``): ``evaluate`` loads a
run's checkpoint, synthesizes every test item with the model on the run's
device (the card unless ``proc.cpu=true``), scores the model and the
analytic modal baseline against the FDTD target on that device, and writes
``score/output.txt`` and ``score/modals.txt``.  Checkpoints are
``torch.save`` files ``<save_dir>/string/ckpt/checkpoints/step_<n>.pt``
holding the model's parameters and constants.  Training, resume and the
code-snapshot delegation come with the training slice; plots with ROADMAP
Queue 1 item 12.
"""

from __future__ import annotations

import glob
import json
import os
import re

import torch

from ..data.dataset import DataLoader, Testset
from ..models.losses import build_loss_registry
from ..models.objective import build_metric_registry
from . import synthesize as S
from .callbacks import save_results, save_test_results
from .simulate import select_device

HEADER = ["x_grid", "kappa", "alpha", "p_a", "p_x", "si_sdr", "sdr", "logmag", "f0_error"]


def _ckpt_dir(save_dir):
    return os.path.join(save_dir, "string", "ckpt", "checkpoints")


def _log(save_dir, record):
    """Append one JSON line to ``<save_dir>/metrics.jsonl``."""
    def num(v):
        return float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v

    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({k: num(v) for k, v in record.items()}) + "\n")


def save_checkpoint(save_dir, model, step):
    """Write ``step_<n>.pt``: the model's parameters and constants (its
    persistent buffers), the inference artifact of a run."""
    path = os.path.abspath(os.path.join(_ckpt_dir(save_dir), f"step_{step}.pt"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    constants = {k: v.detach().cpu() for k, v in model.named_buffers()
                 if k in model.state_dict()}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"params": params, "constants": constants, "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_path, model):
    """Load ``ckpt_path`` into ``model`` strictly: no entry left over on
    either side."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict({**ckpt["params"], **ckpt["constants"]}, strict=True)
    return ckpt["step"]


def _step(path):
    return int(re.search(r"step_(\d+)", os.path.basename(path)).group(1))


def latest_checkpoint(run_dir, prefer_best=False):
    """The run's checkpoint (reference trainer.py:21-27): the one a
    ``BEST`` marker names when ``prefer_best`` and it exists, else the
    latest step."""
    pats = [f"{run_dir}/string/*/checkpoints/step_*.pt", f"{run_dir}/checkpoints/step_*.pt"]
    hits = [h for p in pats for h in glob.glob(p)]
    if not hits:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    for p in pats if prefer_best else []:
        for m in glob.glob(os.path.join(os.path.dirname(p), "BEST")):
            with open(m) as f:
                best = f.read().split()[0]
            cand = os.path.join(os.path.dirname(m), f"step_{best}.pt")
            if os.path.isfile(cand):
                return cand
    return sorted(hits, key=_step)[-1]


def evaluate(args, save_dir):
    """Test loop: model + analytic-modal baseline scores (reference
    synthesize.py:385-476 + callbacks.py SaveTestResults).  Returns the
    model's and the baseline's score rows."""
    task = args.task
    if task.get("plot") or task.get("plot_test_video"):
        raise NotImplementedError(
            "task.plot / task.plot_test_video are not ported yet (ROADMAP.md Queue 1 "
            "item 12); pass task.plot=false")
    device = select_device(args.proc.cpu)
    run_dir = task.ckpt_dir or save_dir
    model = S.build_model(args, generator=torch.Generator().manual_seed(args.proc.seed))
    ckpt = latest_checkpoint(run_dir, prefer_best=True)
    load_checkpoint(ckpt, model)
    model = model.to(device).eval()
    block, sr = args.model.block_size, task.sr

    testset = Testset(task.load_dir, task.load_name, split="test",
                      x_stride=int(task.get("x_stride", 1) or 1))
    test_loader = DataLoader(testset, task.test_batch_size, shuffle=False)
    registry = build_loss_registry(sr, sr)
    criteria = [c for c in task.loss_criteria if c in registry]
    # the test step synthesizes from the estimator's modes unless
    # model.use_precomputed_mode (synthesize.py:409-410; dmsp.yaml: false)
    upm = bool(args.model.get("use_precomputed_mode", False))
    eval_step = S.make_eval_step(model, registry, criteria, model.inharmonic,
                                 use_gt_modes=upm)
    metric_registry = build_metric_registry(sr)
    eval_criteria = [c for c in task.get("eval_criteria", []) if c in metric_registry]

    out_rows, mod_rows, ids = [], [], []
    for bi, batch in enumerate(test_loader):
        prep = S.prepare_batch(batch, model.n_modes, block, sr)
        dprep = S.to_device(prep, device)
        generator = torch.Generator(device=device).manual_seed(bi)
        outputs, _ = eval_step(dprep, generator)
        n = outputs["preds"].shape[-1]
        # scored on the model's device, float64; the modal baseline uses its
        # own pitch track ua_f0 (reference synthesize.py:421-426)
        model_scores = S.summarize_eval_scores(prep, outputs["preds"], outputs["target"],
                                               outputs["preds_f0"], prep["gt_f0"], sr)
        modal_scores = S.summarize_eval_scores(prep, dprep["analytic"][..., :n],
                                               outputs["target"],
                                               prep.get("an_f0", prep["gt_f0"]),
                                               prep["gt_f0"], sr)
        # running metric accumulators (torchmetrics dist_reduce_fx="sum")
        for c in eval_criteria:
            metric, keys = metric_registry[c]
            metric.update(*[outputs[k] for k in keys])
        for i in range(len(prep["gt"])):
            ids.append(f"0-{bi}-{i}")
            out_rows.append([float(model_scores[k][i]) for k in HEADER])
            mod_rows.append([float(modal_scores[k][i]) for k in HEADER])
        # flush partial tables every few batches: a crash mid-scoring keeps
        # the rows already scored, under names no consumer takes for final
        if bi % 8 == 7:
            save_test_results(save_dir, out_rows, HEADER, name="output.partial", ids=ids,
                              partial=True)
            save_test_results(save_dir, mod_rows, HEADER, name="modals.partial", ids=ids,
                              partial=True)
        if task.get("save_results"):
            save_results(os.path.join(save_dir, "eval", str(task.load_name)),
                         outputs["preds"].cpu().numpy(), sr,
                         ids=[f"0-{bi}-{i}" for i in range(len(prep["gt"]))])

    save_test_results(save_dir, out_rows, HEADER, name="output", ids=ids)
    save_test_results(save_dir, mod_rows, HEADER, name="modals", ids=ids)
    for leftover in ("output.partial.txt", "modals.partial.txt"):
        p = os.path.join(save_dir, "score", leftover)
        if os.path.exists(p):
            os.remove(p)
    if eval_criteria:
        rec = {"split": "test"}
        rec.update({f"test/{c}": metric_registry[c][0].compute() for c in eval_criteria})
        _log(save_dir, rec)
        print("[trainer] test metrics: " + " ".join(
            f"{c}={metric_registry[c][0].compute():.4f}" for c in eval_criteria))
    print(f"[trainer] wrote scores for {len(out_rows)} items -> "
          f"{os.path.join(save_dir, 'score')}")
    return out_rows, mod_rows
