"""VQ encode->decode eyeball check (twin of
cogview_tpu/preprocess/recover_grid.py): the reference's
``show_recover_results`` (preprocess/utils.py:23-31) as a helper, with the
originals on the top row and their VQ round trips on the bottom row, saved
as one PNG grid through ``utils/png.py::write_png``.
"""

from __future__ import annotations

import numpy as np

from ..models.vqvae import IMG_MEAN, IMG_STD
from ..utils.png import write_png


def denormalize(img: np.ndarray) -> np.ndarray:
    """Model-input normalized [h,w,3] -> displayable float32 in [0,1]."""
    out = np.asarray(img, np.float32) * np.asarray(IMG_STD, np.float32)
    out = out + np.asarray(IMG_MEAN, np.float32)
    return np.clip(out, 0.0, 1.0)


def write_recover_grid(vq, images, path: str) -> np.ndarray:
    """Encode->decode ``images`` ([b,h,w,3] normalized model inputs) with
    tokenizer ``vq`` and write a 2-row grid PNG (top: originals, bottom:
    roundtrips) to ``path``.  Returns the grid array [2h, b*w, 3]."""
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[None]
    codes = vq.EncodeAsIds(images)
    recovered = np.clip(vq.DecodeIds(codes), 0.0, 1.0)
    top = np.concatenate([denormalize(im) for im in images], axis=1)
    bottom = np.concatenate(list(np.asarray(recovered, np.float32)), axis=1)
    grid = np.concatenate([top, bottom], axis=0)
    write_png(path, (grid * 255).astype(np.uint8))
    return grid
