"""Corpus readers (data_utils/datasets.py rebuilt, torch-free).

Two on-disk formats:

* ``BinaryDataset`` — the reference's flat int32 memmap, one fixed-length
  row per sample (64 text + 1024 code ids, datasets.py:63-81).  Zero-copy
  via np.memmap; this is the production training format.
* ``IndexedDataset`` — this framework's replacement for the reference's
  pickled-LMDB corpora: ``<p>.bin`` (concatenated int32 rows) +
  ``<p>.idx.npy`` (int64 offsets, one per sample + terminator).  Random
  access without a KV store, mmap-friendly, and writable from the
  preprocessing pipeline.

``get_dataset_by_type`` reproduces the three process_fn flavors of
datasets.py:83-130 ('TokenizedDataset', 'TextCodeDataset',
'CompactBinaryDataset'): each __getitem__ yields {'text', 'loss_mask'}
padded to max-length with [PAD] and a 1/0 mask.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from .templates import TextCodeTemplate


class BinaryDataset:
    def __init__(
        self,
        path: str,
        process_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        length_per_sample: int = 64 + 1024,
        dtype: str = "int32",
        preload: bool = False,
        **_,
    ):
        self.length_per_sample = length_per_sample
        self.dtype = np.dtype(dtype)
        self.process_fn = process_fn
        if preload:
            self.bin = np.fromfile(path, dtype=self.dtype).reshape(-1, length_per_sample)
        else:
            flen = os.path.getsize(path) // self.dtype.itemsize
            self.bin = np.memmap(
                path, dtype=self.dtype,
                shape=(flen // length_per_sample, length_per_sample),
            )

    def __len__(self):
        return self.bin.shape[0]

    def __getitem__(self, index):
        return self.process_fn(self.bin[index])


class IndexedDataset:
    """Variable-length rows: data at <path>.bin, offsets at <path>.idx.npy."""

    def __init__(self, path: str, process_fn=None, dtype: str = "int32", **_):
        self.dtype = np.dtype(dtype)
        self.process_fn = process_fn or (lambda row: row)
        self.offsets = np.load(path + ".idx.npy")
        flen = os.path.getsize(path + ".bin") // self.dtype.itemsize
        self.data = np.memmap(path + ".bin", dtype=self.dtype, shape=(flen,))

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, index):
        row = self.data[self.offsets[index] : self.offsets[index + 1]]
        return self.process_fn(row)

    @staticmethod
    def write(path: str, rows, dtype: str = "int32") -> None:
        offsets = [0]
        with open(path + ".bin", "wb") as f:
            for row in rows:
                arr = np.asarray(row, dtype=dtype)
                f.write(arr.tobytes())
                offsets.append(offsets[-1] + len(arr))
        np.save(path + ".idx.npy", np.asarray(offsets, np.int64))


def make_pad_fn(tokenizer, max_len: int):
    pad_id = tokenizer["[PAD]"]

    def pad_to_len(ret: np.ndarray):
        ret = np.asarray(ret, np.int64)
        if len(ret) < max_len:
            sep = len(ret)
            ret = np.concatenate((ret, np.full(max_len - sep, pad_id, np.int64)))
        else:
            sep = max_len
            ret = ret[:max_len]
        return ret, sep

    return pad_to_len


class LMDBDataset:
    """Live reads of a reference pickled-LMDB corpus through the
    from-scratch B-tree reader (data/lmdb_io.py) — the reference's
    LMDBDataset (datasets.py:34-61) without liblmdb and without an import
    step.  Rows are pickled under ``str(i)`` keys with a ``'length'``
    row-count key."""

    def __init__(self, path: str, process_fn, **_):
        from .lmdb_io import LMDBCorpusReader

        self.reader = LMDBCorpusReader(path)
        self.process_fn = process_fn

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, index):
        return self.process_fn(self.reader[index])


def is_lmdb_path(path: str) -> bool:
    """An LMDB environment: a data.mdb file, or a directory holding one
    (the reference opens such dirs via lmdb.open, datasets.py:36)."""
    if path.endswith(".mdb") and os.path.isfile(path):
        return True
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, "data.mdb"))


def get_dataset_by_type(
    dataset_type: str,
    path: str,
    tokenizer,
    max_len: int = 1089,
    **kwargs,
):
    pad_to_len = make_pad_fn(tokenizer, max_len)
    lmdb = is_lmdb_path(path)

    def as_sample(ret):
        ret, sep = pad_to_len(ret)
        mask = np.zeros(max_len, np.float32)
        mask[:sep] = 1.0
        return {"text": ret.astype(np.int32), "loss_mask": mask}

    if dataset_type == "TokenizedDataset":
        def process_fn(row):
            return as_sample(np.asarray(row).flatten())

        if lmdb:
            return LMDBDataset(path, process_fn)
        return IndexedDataset(path, process_fn, **kwargs)

    if dataset_type == "TextCodeDataset":
        if lmdb:
            # reference LMDB rows are pickled (text, code) pairs
            def process_fn(row):
                text, code = row[0], np.asarray(row[1], np.int64).flatten()
                return as_sample(TextCodeTemplate(tokenizer, text, code))

            return LMDBDataset(path, process_fn)

        # rows alternate (text ids..., -1 separator, code ids...) in our
        # indexed format; the reference stored (text, code) pickled pairs
        def process_fn(row):
            row = np.asarray(row, np.int64)
            sep_positions = np.nonzero(row < 0)[0]
            cut = sep_positions[0] if len(sep_positions) else len(row) - 1024
            text, code = row[:cut], row[cut + 1 :] if len(sep_positions) else row[cut:]
            return as_sample(TextCodeTemplate(tokenizer, text, code))

        return IndexedDataset(path, process_fn, **kwargs)

    if dataset_type == "CompactBinaryDataset":
        # 64 text ids (padded with -1) + 1024 code ids per row
        def process_fn(row):
            row = np.asarray(row, np.int64)
            text, code = row[:64], row[64:]
            text = text[text > -1]
            return as_sample(TextCodeTemplate(tokenizer, text, code))

        if lmdb:  # same row convention, LMDB-resident (hot-reload path)
            return LMDBDataset(path, process_fn)
        return BinaryDataset(path, process_fn, **kwargs)

    raise ValueError(f"unknown dataset type {dataset_type}")
