"""Arrange a flat prepared dataset into train/valid/test split dirs.

    python -m torch_fdtd_string_tpu_torch.tools.make_splits <root> [valid_n] [test_n]

The DMSP loaders read ``{load_dir}/{load_name}/{split}/{string_id}/ut-*.wav``
(reference ``src/dataset/synthesize.py:45``); the fused dataset path writes
its items flat into ``<save_dir>-prep/``, so a corpus needs a one-time
deterministic split.  Each item dir (one holding ``parameters.npz``) is
moved into a split subdir, ordered by the SHA-1 of its name so that reruns
are stable: the first ``test_n`` go to ``test``, the next ``valid_n`` to
``valid``, the rest to ``train``.  Port of the repository's
``tools/make_splits.py``.
"""

from __future__ import annotations

import hashlib
import os
import sys

SPLITS = ("train", "valid", "test")


def make_splits(root, valid_n=20, test_n=20):
    """Split ``root``'s item dirs; returns the item count per split."""
    dirs = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and d not in SPLITS
        and os.path.exists(os.path.join(root, d, "parameters.npz"))
    )
    # hashing decouples the split from the generation order
    dirs.sort(key=lambda d: hashlib.sha1(d.encode()).hexdigest())
    for s in SPLITS:
        os.makedirs(os.path.join(root, s), exist_ok=True)
    for i, d in enumerate(dirs):
        split = "test" if i < test_n else "valid" if i < test_n + valid_n else "train"
        os.rename(os.path.join(root, d), os.path.join(root, split, d))
    counts = {s: len(os.listdir(os.path.join(root, s))) for s in SPLITS}
    print(f"[make_splits] {root}: {counts}")
    return counts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    make_splits(argv[0], int(argv[1]) if len(argv) > 1 else 20,
                int(argv[2]) if len(argv) > 2 else 20)


if __name__ == "__main__":
    main()
