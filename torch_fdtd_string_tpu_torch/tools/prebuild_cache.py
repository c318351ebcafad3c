"""Build the trainer's host caches of a prepared corpus ahead of training.

    python -m torch_fdtd_string_tpu_torch.tools.prebuild_cache --load-name <corpus> \\
        [--data-dir ./results] [--x-stride 1] [--n-modes 40] [--block 256] \\
        [--sr 48000] [--trim-s 1.0] [--splits train,valid,test]

Port of the repository's ``tools/prebuild_cache.py``.  Before its first
step ``proc.train`` prepares every item of the corpus's splits into one
host array per field, ``<data-dir>/<corpus>/_prep_<split>_<tag>.npz``
(``tasks/trainer.py::_build_host_cache``), which takes long on a large
corpus.  This tool writes those files beforehand, on the host, under the
names the trainer looks for (``<tag>`` =
``<n_modes>_<block>_<sr>_<trim>_x<x_stride>``, the flags' defaults being
synth-dmsp's); a file that exists is left as it is, and the trainer
rebuilds one whose row count is not its split's.  Host numpy: no device.
"""

from __future__ import annotations

import argparse
import os

from ..data.dataset import Testset, Trainset
from ..tasks.trainer import _build_host_cache, cache_tag


def prebuild(load_name, data_dir="./results", x_stride=1, n_modes=40, block=256, sr=48000,
             trim_s=1.0, splits=("train", "valid", "test")):
    """Write the host cache of each of ``splits``; returns their paths."""
    trim = int(trim_s * sr)
    tag = cache_tag(n_modes, block, sr, trim, x_stride)
    sets = {
        "train": lambda: Trainset(data_dir, load_name, trim=trim, x_stride=x_stride),
        "valid": lambda: Testset(data_dir, load_name, split="valid", x_stride=x_stride),
        "test": lambda: Testset(data_dir, load_name, split="test", x_stride=x_stride),
    }
    paths = []
    for split in splits:
        path = os.path.join(data_dir, load_name, f"_prep_{split}_{tag}.npz")
        paths.append(path)
        if os.path.exists(path):
            print(f"[prebuild] {path} exists, skipping")
            continue
        ds = sets[split]()
        print(f"[prebuild] {split}: {len(ds)} items -> {path}", flush=True)
        _build_host_cache(ds, n_modes, block, sr, cache_path=path, drop=("analytic",))
    print("[prebuild] done")
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load-name", required=True)
    ap.add_argument("--data-dir", default="./results")
    ap.add_argument("--x-stride", type=int, default=1)
    ap.add_argument("--n-modes", type=int, default=40)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--trim-s", type=float, default=1.0)
    ap.add_argument("--splits", default="train,valid,test",
                    help="comma list, e.g. test alone for scoring without a train scan")
    a = ap.parse_args(argv)
    splits = [s.strip() for s in a.splits.split(",") if s.strip()]
    return prebuild(a.load_name, a.data_dir, a.x_stride, a.n_modes, a.block, a.sr, a.trim_s,
                    splits)


if __name__ == "__main__":
    main()
