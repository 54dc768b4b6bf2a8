"""ctypes binding of the port's native corpus reader (csrc/dataio/dataio.cc;
twin of cogview_tpu/data/native_loader.py).

``NativeCompactDataset`` assembles whole {text, loss_mask} batches of a
CompactBinary corpus in C++ (mmap and template expansion over threads),
equal to ``CompactBinaryDataset``'s rows.  The library is built with
``g++`` at first use (``ops/_kernels.build_host``); a failed build or load
raises.  As in the JAX package, no CLI reads through it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _kernels

_LIB = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_kernels.build_host(["dataio"])[0]))
        lib.dio_open.restype = ctypes.c_void_p
        lib.dio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dio_num_samples.restype = ctypes.c_int64
        lib.dio_num_samples.argtypes = [ctypes.c_void_p]
        lib.dio_fill_batch.restype = ctypes.c_int
        lib.dio_fill_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.dio_close.restype = None
        lib.dio_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class NativeCompactDataset:
    """Batch-level reader of CompactBinary corpora (native assembly)."""

    def __init__(self, path: str, tokenizer, max_len: int = 1089,
                 length_per_sample: int = 64 + 1024, text_region: int = 64,
                 n_threads: int = 4):
        self._lib = get_lib()
        self._h = self._lib.dio_open(str(path).encode(), length_per_sample)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.n = int(self._lib.dio_num_samples(self._h))
        self.max_len = max_len
        self.text_region = text_region
        self.n_threads = n_threads
        self._ids = (tokenizer["[ROI1]"], tokenizer["[BASE]"], tokenizer["[BOI1]"],
                     tokenizer["[EOI1]"], tokenizer["[PAD]"])

    def __len__(self):
        return self.n

    def batch(self, indices: np.ndarray):
        indices = np.ascontiguousarray(indices, np.int64)
        B = len(indices)
        text = np.empty((B, self.max_len), np.int32)
        mask = np.empty((B, self.max_len), np.float32)
        roi1, base, boi1, eoi1, pad = self._ids
        rc = self._lib.dio_fill_batch(
            self._h, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), B,
            self.text_region, self.max_len, roi1, base, boi1, eoi1, pad,
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.n_threads)
        if rc != 0:
            raise IndexError("dio_fill_batch failed (index out of range?)")
        return {"text": text, "loss_mask": mask}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dio_close(h)
            self._h = None
