"""Streaming TSV eval corpus (twin of cogview_tpu/eval_utils/dataset.py):
the reference's ``TsvDataset`` (eval_utils/dataset.py:9-33) as a plain
generator.

Row layout (reference eval_utils/dataset.py:28-32):

  * default: ``id \\t _ \\t caption \\t image_base64``: the image is the
    urlsafe-base64 of an encoded image file in column 3, caption in
    column 2.
  * ``caption_only``: ``id \\t caption``: no image column; yields a zero
    image placeholder like the reference does.

Images are decoded by the port's readers, chosen as Pillow's
``Image.open`` chooses its plugin (``utils/image_formats.py::
decode_image``), and, where their size differs, resized as Pillow's
``Image.resize((s, s))`` does with its default filter, BICUBIC for RGB
(``resize_bicubic``), byte-equal.  Every row ends in one of the three
outcomes of ``utils/image_errors.py``: its image is read as Pillow reads
it; an image Pillow reads and the port does not stops the stream with an
``UnsupportedImageError``; a row that is short, not base64, or holds bytes
Pillow cannot open or load is skipped and counted (``skipped``), as the
JAX package skips it.
"""

from __future__ import annotations

import base64
import binascii
import csv
import sys
from typing import Iterator, Optional, Tuple

import numpy as np

from ..models.vqvae import decode_image, resize_bicubic
from ..preprocess.raw_datasets import DECODE_ERRORS
from ..utils.image_errors import UnsupportedImageError
from ..utils.png import encode_png


class TsvImageStream:
    """Iterate a base64-image TSV: yields ``(image, id, caption)`` with
    ``image`` an ``[img_size, img_size, 3]`` float32 array in [0, 1].

    Attributes after (partial) iteration: ``yielded``, ``skipped``.
    """

    def __init__(self, path: str, img_size: int = 256,
                 caption_only: bool = False, limit: int = 0):
        self.path = path
        self.img_size = img_size
        self.caption_only = caption_only
        self.limit = limit
        self.yielded = 0
        self.skipped = 0

    def __iter__(self) -> Iterator[Tuple[Optional[np.ndarray], str, str]]:
        s = self.img_size
        zeros = np.zeros((s, s, 3), np.float32)
        with open(self.path, "r", encoding="utf-8", newline="") as f:
            for line in csv.reader(f, delimiter="\t"):
                if self.limit and self.yielded >= self.limit:
                    return
                if self.caption_only:
                    if len(line) < 2:
                        self.skipped += 1
                        continue
                    self.yielded += 1
                    yield zeros, line[0], line[1]
                    continue
                if len(line) < 4:
                    self.skipped += 1
                    continue
                try:
                    img = decode_image(base64.urlsafe_b64decode(line[3]))
                except UnsupportedImageError as e:
                    raise UnsupportedImageError(f"{self.path}, row {line[0]!r}: {e}") from None
                except (binascii.Error,) + DECODE_ERRORS:
                    self.skipped += 1
                    continue
                if img.shape[:2] != (s, s):
                    img = resize_bicubic(img, s, s)
                self.yielded += 1
                yield (np.asarray(img, np.float32) / 255.0, line[0], line[2])
        if self.skipped:
            print(f"[warn] {self.path}: skipped {self.skipped} undecodable "
                  f"TSV rows (reference substitutes zero images instead)",
                  file=sys.stderr)


def iter_tsv_image_batches(path: str, batch_size: int, img_size: int = 256,
                           limit: int = 0) -> Iterator[np.ndarray]:
    """Batch the image column of a TSV stream: yields [b, s, s, 3] float32."""
    buf = []
    for img, _id, _cap in TsvImageStream(path, img_size=img_size, limit=limit):
        buf.append(img)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def encode_image_base64(img: np.ndarray, fmt: str = "PNG") -> str:
    """Inverse helper (tests / corpus authoring): [h,w,3] float in [0,1]
    -> urlsafe-base64 of a PNG file, the reference's column-3 format.  PNG
    only: the port has no JPEG encoder."""
    if fmt.upper() != "PNG":
        raise ValueError(f"encode_image_base64 writes PNG only, not {fmt!r} "
                         "(this package has no JPEG encoder)")
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return base64.urlsafe_b64encode(encode_png(arr)).decode("ascii")
