"""Global-batch data loading for SPMD training.

The reference stack (data_utils/configure_data.py + samplers.py) builds a
per-rank torch DataLoader whose DistributedBatchSampler slices each global
batch by rank.  This loader (the port's copy of cogview_tpu/data/loader.py)
yields the GLOBAL batch as numpy arrays; the train step moves it to the
device.  Reproduced semantics:

* epoch-seeded deterministic shuffling (samplers.py RandomSampler:24-73:
  permutation seeded by epoch);
* ``start_iter`` fast-forward for exact dataloader resume
  (DistributedBatchSampler:121-133);
* multi-path datasets with x4 oversampling for t2i paths and x2 for i2t
  (configure_data.py:57-84), implemented by index repetition;
* ``RandomMappingDataset``-style x200 pseudo-shuffle expansion
  (configure_data.py:276-291) falls out of sampling indices with
  replacement when oversample > 1;
* train/val/test split by ratio (configure_data.py:182-274) via a
  deterministic permutation of sample indices;
* ``detect_new_datasets`` polling (configure_data.py:293-310).

A background thread prefetches the next batch while the step runs.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .datasets import get_dataset_by_type, is_lmdb_path


@dataclasses.dataclass
class DataConfig:
    train_data: Sequence[str] = ()
    dataset_type: str = "CompactBinaryDataset"
    split: Sequence[float] = (0.95, 0.04, 0.01)  # train/val/test
    batch_size: int = 4  # GLOBAL batch
    max_len: int = 1089
    length_per_sample: int = 64 + 1024
    seed: int = 1234
    shuffle: bool = True
    oversample_t2i: int = 4  # configure_data.py:70-75
    oversample_i2t: int = 2


class _SplitView:
    def __init__(self, ds, indices: np.ndarray):
        self.ds = ds
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[int(self.indices[i])]


class _Concat:
    def __init__(self, parts: List):
        self.parts = parts
        self.cum = np.cumsum([len(p) for p in parts])

    def __len__(self):
        return int(self.cum[-1]) if len(self.parts) else 0

    def __getitem__(self, i):
        pi = int(np.searchsorted(self.cum, i, side="right"))
        prev = 0 if pi == 0 else int(self.cum[pi - 1])
        return self.parts[pi][i - prev]


def _path_weight(path: str, cfg: DataConfig) -> int:
    if "t2i" in path:
        return cfg.oversample_t2i
    if "i2t" in path:
        return cfg.oversample_i2t
    return 1


def build_dataset(cfg: DataConfig, tokenizer, paths: Optional[Sequence[str]] = None):
    parts = []
    for p in paths if paths is not None else cfg.train_data:
        ds = get_dataset_by_type(
            cfg.dataset_type, p, tokenizer,
            max_len=cfg.max_len, length_per_sample=cfg.length_per_sample,
        )
        for _ in range(_path_weight(p, cfg)):
            parts.append(ds)
    return _Concat(parts)


def split_dataset(ds, split: Sequence[float], seed: int):
    """Deterministic permutation split (SplitDataset semantics)."""
    n = len(ds)
    perm = np.random.RandomState(seed).permutation(n)
    out = []
    start = 0
    for i, frac in enumerate(split):
        take = int(round(n * frac)) if i < len(split) - 1 else n - start
        take = min(take, n - start)
        out.append(_SplitView(ds, perm[start : start + take]) if take > 0 else None)
        start += take
    return out


class BatchIterator:
    """Deterministic, resumable global-batch iterator."""

    def __init__(self, ds, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, prefetch: int = 2):
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.start_iter = 0  # fast-forward within the current epoch
        self._prefetch = prefetch

    def batches_per_epoch(self) -> int:
        n = len(self.ds) // self.batch_size
        return n if self.drop_last else -(-len(self.ds) // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.ds))
        return np.random.RandomState(self.seed + epoch).permutation(len(self.ds))

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        keys = samples[0].keys()
        return {k: np.stack([s[k] for s in samples]) for k in keys}

    def _epoch_batches(self, epoch: int, skip: int) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order(epoch)
        nb = self.batches_per_epoch()
        for b in range(skip, nb):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            yield self._collate([self.ds[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            epoch, skip = self.epoch, self.start_iter
            while True:
                yield from self._epoch_batches(epoch, skip)
                epoch, skip = epoch + 1, 0
                self.epoch = epoch

        if self._prefetch <= 0:
            return gen()
        return _prefetch_iter(gen(), self._prefetch)

    def state_dict(self):
        return {"epoch": self.epoch, "start_iter": self.start_iter}

    def fast_forward(self, iterations: int) -> None:
        """Position the iterator as if ``iterations`` global batches were
        already consumed (the --resume-dataloader path,
        pretrain_gpt2.py:766-774)."""
        nb = self.batches_per_epoch()
        self.epoch = iterations // nb
        self.start_iter = iterations % nb


def _prefetch_iter(it, depth: int):
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def worker():
        try:
            for x in it:
                q.put(x)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is _SENTINEL:
            return
        yield x


def make_loaders(cfg: DataConfig, tokenizer):
    """-> (train, val, test) BatchIterators (None when split is empty).

    Val/test iterators are built with prefetch=0: eval consumers iterate
    them intermittently, and a daemon prefetch thread per ``iter()`` call
    would leak (blocked on q.put) every eval interval."""
    ds = build_dataset(cfg, tokenizer)
    train_ds, val_ds, test_ds = split_dataset(ds, cfg.split, cfg.seed)
    mk = lambda d, shuffle, prefetch: (
        BatchIterator(d, cfg.batch_size, seed=cfg.seed, shuffle=shuffle,
                      prefetch=prefetch)
        if d is not None and len(d) >= cfg.batch_size
        else None
    )
    return (mk(train_ds, cfg.shuffle, 2), mk(val_ds, False, 0),
            mk(test_ds, False, 0))


def detect_new_datasets(cfg: DataConfig, tokenizer, known_paths: set):
    """Poll the training-data directory for new corpora
    (configure_data.py:293-310); returns a new train iterator or None.

    The polled pattern follows ``cfg.dataset_type``: CompactBinary
    corpora are flat ``*.bin`` files; Tokenized/TextCode corpora are
    IndexedDatasets addressed by base path (``<base>.bin`` +
    ``<base>.idx.npy``).  LMDB environments (dirs holding a data.mdb, or
    bare ``*.mdb``/``*lmdb`` entries — the reference watched entries
    ending 'lmdb', configure_data.py:302-305) are detected in every mode
    and read directly through data/lmdb_io.py, no import step."""
    if not cfg.train_data:
        return None, known_paths
    base = os.path.dirname(cfg.train_data[0])
    if cfg.dataset_type == "CompactBinaryDataset":
        found = set(glob.glob(os.path.join(base, "*.bin")))
    else:
        found = {
            p[: -len(".idx.npy")]
            for p in glob.glob(os.path.join(base, "*.idx.npy"))
            if os.path.exists(p[: -len(".idx.npy")] + ".bin")
        }
    found |= {p for p in glob.glob(os.path.join(base, "*"))
              if is_lmdb_path(p)}
    current = set(known_paths)
    if found - current:
        paths = sorted(current | found)
        ds = build_dataset(cfg, tokenizer, paths=paths)
        train_ds, _, _ = split_dataset(ds, cfg.split, cfg.seed)
        return (
            BatchIterator(train_ds, cfg.batch_size, seed=cfg.seed, shuffle=cfg.shuffle),
            set(paths),
        )
    return None, known_paths
