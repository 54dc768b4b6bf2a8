"""Batch VQ tokenization -> training corpora (twin of
cogview_tpu/preprocess/tokenize_images.py; framework-free, the same code).

The reference's preprocess/pretokenized_data.py and
preprocess_text_image_data.py:

* ``make_text_image_rows`` — text+image pairs -> CompactBinary rows
  (64 text ids padded with -1, then the 1024 image codes): the format
  consumed by CompactBinaryDataset and the native loader;
* ``make_super_resolution_rows`` — the SR finetuning pairs
  (pretokenized_data.py:89-140): per image, a half-res overview plus
  sampled half-size patches at the nine [POS*] grid anchors, emitted as
  full token sequences '[ROI1] text [BASE][BOI1] overview [EOI1][ROI2]
  [POSi][BASE][BOI2] patch [EOI2]' for the IndexedDataset writer;
* ``make_cut_text_rows`` — pure-text rows cut to fixed length.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np


class CompactBinaryWriter:
    """Append-only fixed-row .bin writer (text_region + code_len int32)."""

    def __init__(self, path: str, text_region: int = 64, code_len: int = 1024):
        self.f = open(path, "wb")
        self.text_region = text_region
        self.code_len = code_len
        self.count = 0

    def add(self, text_ids: Sequence[int], codes: Sequence[int]) -> None:
        row = np.full(self.text_region + self.code_len, -1, np.int32)
        t = np.asarray(list(text_ids)[: self.text_region], np.int32)
        row[: len(t)] = t
        codes = np.asarray(codes, np.int32)
        assert len(codes) == self.code_len, len(codes)
        row[self.text_region :] = codes
        self.f.write(row.tobytes())
        self.count += 1

    def close(self):
        self.f.close()


def _batched(it: Iterator, n: int):
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def make_text_image_rows(
    vq_tokenizer,
    tokenizer,
    samples: Iterator[Tuple[str, np.ndarray]],  # (name, normalized [h,w,3])
    text_source,
    writer: CompactBinaryWriter,
    batch_size: int = 32,
    log_every: int = 0,
) -> int:
    """VQ-encode images in device batches; write CompactBinary rows."""
    n = 0
    for batch in _batched(samples, batch_size):
        named = [(name, img) for name, img in batch if text_source.lookup(name)]
        if not named:
            continue
        imgs = np.stack([img for _, img in named])
        codes = np.asarray(vq_tokenizer.EncodeAsIds(imgs))
        for (name, _), code in zip(named, codes):
            text_ids = tokenizer.EncodeAsIds(text_source.lookup(name))
            writer.add(text_ids, code)
            n += 1
            if log_every and n % log_every == 0:
                print(f"  {n} samples", flush=True)
    return n


# the nine half-size patch anchors of a [POS*] grid over an s x s image
def _patch_anchors(s: int) -> List[Tuple[int, int]]:
    t0, t1 = s // 4, s // 2
    pw = [0, t0, t1] * 3
    ph = [0, 0, 0, t0, t0, t0, t1, t1, t1]
    return list(zip(ph, pw))


def make_super_resolution_rows(
    vq_tokenizer,
    tokenizer,
    samples: Iterator[Tuple[str, np.ndarray]],  # normalized [s,s,3], s=512
    text_source,
    rows_out: List[np.ndarray],
    img_size: int = 512,
    sampling_num: int = 4,
    batch_size: int = 8,
    seed: int = 0,
) -> int:
    rng = np.random.RandomState(seed)
    t1 = img_size // 2
    anchors = _patch_anchors(img_size)
    size_tk = tokenizer["[BASE]"]
    n = 0
    for batch in _batched(samples, batch_size):
        named = [(name, img) for name, img in batch if text_source.lookup(name)]
        if not named:
            continue
        sel = rng.choice(9, size=(len(named), sampling_num))
        patches, overviews = [], []
        for (name, img), picks in zip(named, sel):
            # half-res overview via 2x2 average pooling (bilinear analog)
            s = img.shape[0]
            ov = img.reshape(s // 2, 2, s // 2, 2, 3).mean(axis=(1, 3))
            overviews.append(ov)
            for p in picks:
                ph, pw = anchors[p]
                patches.append(img[ph : ph + t1, pw : pw + t1])
        codes_over = np.asarray(vq_tokenizer.EncodeAsIds(np.stack(overviews)))
        codes_patch = np.asarray(vq_tokenizer.EncodeAsIds(np.stack(patches)))
        pi = 0
        for (name, _), picks, over in zip(named, sel, codes_over):
            prefix = [tokenizer["[ROI1]"]] + tokenizer.EncodeAsIds(
                text_source.lookup(name)
            ) + [size_tk, tokenizer["[BOI1]"]]
            for p in picks:
                midfix = [
                    tokenizer["[EOI1]"], tokenizer["[ROI2]"],
                    tokenizer[f"[POS{p}]"], size_tk, tokenizer["[BOI2]"],
                ]
                row = np.concatenate([
                    np.asarray(prefix, np.int64), over, np.asarray(midfix, np.int64),
                    codes_patch[pi], [tokenizer["[EOI2]"]],
                ])
                rows_out.append(row.astype(np.int32))
                pi += 1
                n += 1
    return n


def make_cut_text_rows(
    tokenizer, texts: Iterable[str], seq_len: int, rows_out: List[np.ndarray]
) -> int:
    """Pure-text corpus: encode ++ [SEP], cut into fixed seq_len rows
    (preprocess_text_jsonformat_data.py:26-46)."""
    buf: List[int] = []
    n = 0
    sep = tokenizer["[SEP]"]
    for t in texts:
        buf.extend(tokenizer.EncodeAsIds(t))
        buf.append(sep)
        while len(buf) >= seq_len:
            rows_out.append(np.asarray(buf[:seq_len], np.int32))
            buf = buf[seq_len:]
            n += 1
    return n
