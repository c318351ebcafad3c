"""DMSP datasets and a threaded data loader.

Port of ``torch_fdtd_string_tpu/data/dataset.py`` (reference
``src/dataset/synthesize.py``): items are indexed by
``(string_id * n_x + x)`` over the sorted string directories of a split
and the kept pickup columns ``x_ids``; each item loads the per-x FDTD
target wav (``ut-{x}.wav``), the modal target (``ua-{x}.wav``, zeros when
the corpus was generated without it) and the parameter bundle, with an
optional random time-trim for training.  Items whose ``parameters.npz``
does not open are skipped.

The loader is a threaded prefetcher producing numpy-stacked batches; the
device transfer happens in the caller.  Items' ``mode_freq``/``mode_amps``
are padded/trimmed to ``n_modes_pad`` so that batches stack.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import zipfile

import numpy as np

from ..utils import data as dutil
from ..utils import wav as wavio

KEYS = [
    "x", "t", "kappa", "alpha", "f0", "T60", "u0",
    "mode_freq", "mode_amps", "gain", "ua_f0", "ut_f0",
]


class GenericDataset:
    def __init__(self, data_dir, load_name, split="train", trim=None, Nx=None,
                 n_modes_pad=100, seed=0, x_stride=1):
        self.rng = np.random.default_rng(seed)
        self.trim = trim
        self.n_modes_pad = n_modes_pad
        pattern = f"{data_dir}/{load_name}/{split.lower()}/*/ut-0.wav"

        def string_id(p):
            return p.split("/")[-2]

        paths = sorted(glob.glob(pattern), key=string_id)
        if not paths:
            raise FileNotFoundError(f"[Loader] No data found: {pattern}")
        # a killed generation chunk can leave a truncated npz; skip such
        # items (a header-only open)
        bad = []
        for p in paths:
            try:
                with zipfile.ZipFile(os.path.join(os.path.dirname(p), "parameters.npz")):
                    pass
            except Exception:
                bad.append(p)
        if bad:
            print(f"[Loader] WARNING: skipping {len(bad)} items with "
                  f"corrupt/missing parameters.npz: {[string_id(p) for p in bad[:8]]}...")
            bad_set = set(bad)
            paths = [p for p in paths if p not in bad_set]
        if Nx is None:  # the prepared spatial grid size
            Nx = len(glob.glob(os.path.join(os.path.dirname(paths[0]), "ut-*.wav")))
        self.Nx = Nx
        # spatially uniform pickup subsample: every s-th readout position
        self.x_ids = list(range(0, Nx, max(int(x_stride), 1)))
        self.tgt_list = paths
        self.n_data = len(paths) * len(self.x_ids)

    def __len__(self):
        return self.n_data

    def _pad_modes(self, freq, amps):
        n = len(freq)
        m = self.n_modes_pad
        if n >= m:
            return freq[:m], amps[:m]
        freq_p = np.pad(freq, (0, m - n), mode="edge")
        amps_p = np.pad(amps, ((0, m - n), (0, 0)))
        return freq_p, amps_p

    def load_data(self, tgt_path):
        parts = tgt_path.split("/")
        string_dir = "/".join(parts[:-1])
        x_idx = int(os.path.splitext(parts[-1])[0].split("-")[-1])
        npz_path = os.path.join(string_dir, "parameters.npz")
        lin_path = tgt_path.replace("ut-", "ua-")
        # items generated with task.save_modal=false carry no modal baseline
        linear_wave = wavio.read(lin_path)[0] if os.path.exists(lin_path) else None
        keys = KEYS if linear_wave is not None else [k for k in KEYS if k != "ua_f0"]
        # the target is read once: its length picks the trim window
        tgt_wave = None
        if linear_wave is not None:
            Nt = len(linear_wave)
        else:
            tgt_wave, _ = wavio.read(tgt_path)
            Nt = len(tgt_wave)
        if self.trim is not None and Nt > self.trim:
            st = int(self.rng.integers(Nt - self.trim))
            et = st + self.trim
            if linear_wave is not None:
                linear_wave = linear_wave[st:et]
            item = dutil.load_wav(tgt_path, npz_path, (st, et), keys=keys, wav=tgt_wave)
        else:
            item = dutil.load_wav(tgt_path, npz_path, keys=keys, wav=tgt_wave)
        if linear_wave is None:
            linear_wave = np.zeros_like(item["target"])

        freq, amps = self._pad_modes(np.asarray(item["mode_freq"]).reshape(-1),
                                     np.asarray(item["mode_amps"]))
        item["mode_freq"] = freq
        item["mode_amps"] = amps
        item["x"] = np.asarray(item["x"]).reshape(-1)[x_idx]
        item["mode_coef"] = amps[:, x_idx][None, None, :]
        item["analytic"] = linear_wave
        return item

    def __getitem__(self, index):
        nx = len(self.x_ids)
        anchor = self.tgt_list[index // nx]
        x_idx = self.x_ids[index % nx]
        return self.load_data(anchor.replace("ut-0.wav", f"ut-{x_idx}.wav"))


class Trainset(GenericDataset):
    def __init__(self, data_dir, load_name, trim=None, **kw):
        super().__init__(data_dir, load_name, split="train", trim=trim, **kw)
        print(f"[Loader] Train samples:\n\t(total) {len(self)}")


class Testset(GenericDataset):
    def __init__(self, data_dir, load_name, split="test", trim=None, **kw):
        super().__init__(data_dir, load_name, split=split, trim=trim, **kw)
        print(f"[Loader] {split} samples:\n\t(total) {len(self)}")


def _collate(items):
    return {key: np.stack([np.asarray(it[key]) for it in items]) for key in items[0]}


class DataLoader:
    """Shuffling, batching, threaded-prefetch iterator over a dataset."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False, seed=0):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = [idx[i:i + self.bs] for i in range(0, len(idx), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]

        q: queue.Queue = queue.Queue(maxsize=4)
        stop = object()
        errors = []
        closed = threading.Event()

        def worker():
            try:
                for b in batches:
                    if closed.is_set():
                        break
                    q.put(_collate([self.ds[int(i)] for i in b]))
            except BaseException as err:  # handed to the consumer
                errors.append(err)
            finally:
                q.put(stop)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # a consumer that stops early (one batch taken) ends the worker:
            # drain the queue until it sees the flag and exits
            closed.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
        if errors:
            raise errors[0]
