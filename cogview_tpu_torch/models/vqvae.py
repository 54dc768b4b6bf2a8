"""VQ-VAE image tokenizer (twin of cogview_tpu/models/vqvae.py, inference).

Released cogview configuration: channel 512, embed_dim 256, n_embed 8192;
the encoder is three stride-2 4x4 convs and a 1x1 projection, the decoder
three stride-2 4x4 transposed convs and a 1x1 projection.  Parameters use
PyTorch's layouts, convs OIHW and transposed convs ``[in, out, kh, kw]``;
the codebook keeps the JAX package's ``[embed_dim, n_embed]``.
Activations are NCHW inside; the public functions take and return the JAX
package's NHWC images and features.

The JAX package lowers ConvTranspose2d(4, 2, 1) to a sub-pixel conv because
its TPU backend runs input-dilated convs slowly; here it is
``conv_transpose2d``.  ``img2code``'s bfloat16 encoder option is not
ported: the codes must match the float32 reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VQVAEConfig
from ..utils.png import read_png

Params = Dict[str, Any]

# Dataset normalization constants (reference vqvae_tokenizer.py:81).
IMG_MEAN = (0.79093, 0.76271, 0.75340)
IMG_STD = (0.30379, 0.32279, 0.32800)


def _uniform(shape, bound, generator, device):
    return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * bound


def init_params(cfg: VQVAEConfig, generator: torch.Generator, device=None) -> Params:
    """Random encoder, decoder and codebook (float32), drawn with
    ``generator``: decoder and codebook first, so they equal the draws of
    a decoder-only init from the same seed."""
    assert cfg.stride == 6 and cfg.n_res_block == 0 and cfg.simple, (
        "only the released cogview configuration is implemented")
    c, e = cfg.channel, cfg.embed_dim

    # Kaiming-uniform fan-in init (torch Conv2d default)
    def conv(cin, cout, k):
        bound = math.sqrt(1.0 / (cin * k * k))
        return {"w": _uniform((cout, cin, k, k), math.sqrt(3.0) * bound, generator, device),
                "b": _uniform((cout,), bound, generator, device)}

    def convt(cin, cout, k):
        bound = math.sqrt(1.0 / (cin * k * k))
        return {"w": _uniform((cin, cout, k, k), math.sqrt(3.0) * bound, generator, device),
                "b": _uniform((cout,), bound, generator, device)}

    # xavier_uniform with tanh gain, as the reference initializes its codebook
    bound = 5.0 / 3.0 * math.sqrt(6.0 / (e + cfg.n_embed))
    decoder = {
        "convt0": convt(e, c, 4),
        "convt1": convt(c, c, 4),
        "convt2": convt(c, c, 4),
        "proj": conv(c, cfg.in_channel, 1),
    }
    embed = _uniform((e, cfg.n_embed), bound, generator, device)
    encoder = {
        "conv0": conv(cfg.in_channel, c, 4),
        "conv1": conv(c, c, 4),
        "conv2": conv(c, c, 4),
        "proj": conv(c, e, 1),
    }
    return {"encoder": encoder, "decoder": decoder, "quantize": {"embed": embed}}


def encode_features(params: Params, img: torch.Tensor) -> torch.Tensor:
    """Normalized image [b, h, w, 3] (NHWC) -> pre-quantization features
    [b, h/8, w/8, embed_dim] (NHWC)."""
    e = params["encoder"]
    x = img.permute(0, 3, 1, 2)
    for name in ("conv0", "conv1", "conv2"):
        x = F.relu(F.conv2d(x, e[name]["w"], e[name]["b"], stride=2, padding=1))
    x = F.conv2d(x, e["proj"]["w"], e["proj"]["b"])
    return x.permute(0, 2, 3, 1)


def nearest_code(embed: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """argmin_j ||z - e_j||^2 as ``||e_j||^2 - 2 z . e_j`` in float32 (the
    constant ||z||^2 dropped); ties go to the lowest index.
    embed [D, K], z [..., D] -> int64 codes [...]."""
    flat = z.reshape(-1, z.shape[-1]).float()
    e = embed.float()
    dist = (e * e).sum(dim=0)[None, :] - 2.0 * (flat @ e)
    return torch.argmin(dist, dim=-1).reshape(z.shape[:-1])


@torch.no_grad()
def img2code(params: Params, img: torch.Tensor) -> torch.Tensor:
    """Normalized image batch [b, h, w, 3] -> flat codes [b, (h/8)*(w/8)]
    int64; float32 convs (TF32 must be off on a card, see ops/precision.py)."""
    z = encode_features(params, img.float())
    return nearest_code(params["quantize"]["embed"], z).reshape(img.shape[0], -1)


def lookup_code(embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes [...] int -> embeddings [..., D] (embed is [D, K])."""
    return embed.t()[codes]


def decode_features(params: Params, quant: torch.Tensor) -> torch.Tensor:
    """quant [b, D, s, s] (NCHW) -> decoder output [b, 3, 8s, 8s]."""
    d = params["decoder"]
    x = quant
    for name in ("convt0", "convt1", "convt2"):
        x = F.relu(F.conv_transpose2d(x, d[name]["w"], d[name]["b"], stride=2, padding=1))
    return F.conv2d(x, d["proj"]["w"], d["proj"]["b"])


@torch.no_grad()
def code2img(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes [b, s*s] or [b, s, s] -> de-normalized float32 image
    [b, 8s, 8s, 3] (NHWC, as the JAX package returns it)."""
    if codes.ndim == 2:
        side = math.isqrt(codes.shape[-1])
        codes = codes.reshape(codes.shape[0], side, side)
    quant = lookup_code(params["quantize"]["embed"], codes.long())  # [b, s, s, D]
    out = decode_features(params, quant.permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1)
    mean = torch.tensor(IMG_MEAN, dtype=out.dtype, device=out.device)
    std = torch.tensor(IMG_STD, dtype=out.dtype, device=out.device)
    return (out * std + mean).float()


# Pillow's fixed-point precision for 8-bit images (libImaging/Resample.c)
PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for its bilinear (triangle, support 1)
    filter over the whole axis, then ``normalize_coeffs_8bpc`` -> (first
    input index [out], integer weights [out, ksize]; a weight past a row's
    support is 0).  The support widens by the downscale factor, so a
    reduction antialiases.  Python floats are the C code's doubles, and the
    sums run in its order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    inv = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        count = min(int(center + support + 0.5), in_size) - xmin
        w = []
        for x in range(count):
            t = abs((x + xmin - center + 0.5) * inv)
            w.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            v = v / total if total != 0.0 else v
            kk[xx, x] = int((0.5 if v >= 0 else -0.5) + v * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit bilinear resample along ``axis`` of a
    uint8 image: sums of pixel x integer weight from half a unit, then
    clipped to [0, 255] and shifted back."""
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    first, kk = _bilinear_coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    x = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, other, 3]
    acc = np.full((out_size,) + x.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for k in range(kk.shape[1]):
        acc += x[idx[:, k]] * kk[:, k].reshape((-1,) + (1,) * (x.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[h, w, 3] uint8 -> [height, width, 3] uint8, equal to Pillow's
    ``Image.resize((width, height), Image.BILINEAR)`` on an RGB image: the
    horizontal pass first, rounded to 8 bits, then the vertical."""
    return _resample_axis(_resample_axis(img, width, 1), height, 0)


def read_img(path: str, img_size: int = 256) -> np.ndarray:
    """A PNG -> the normalized float32 image [1, img_size, img_size, 3], as
    the JAX package's ``read_img``: the short side resized to ``img_size``
    with Pillow's bilinear filter (:func:`resize_bilinear`), then the centre
    crop."""
    img = read_png(path)
    h, w = img.shape[:2]
    if w < h:
        nw, nh = img_size, max(1, round(h * img_size / w))
    else:
        nw, nh = max(1, round(w * img_size / h)), img_size
    img = resize_bilinear(img, nw, nh)
    left, top = (nw - img_size) // 2, (nh - img_size) // 2
    img = img[top:top + img_size, left:left + img_size]
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(IMG_MEAN, np.float32)) / np.asarray(IMG_STD, np.float32)
    return arr[None]
