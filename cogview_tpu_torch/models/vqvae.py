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


def read_img(path: str, img_size: int = 256) -> np.ndarray:
    """A PNG of ``img_size`` x ``img_size`` pixels -> the normalized float32
    image [1, h, w, 3], equal bit for bit to the JAX package's ``read_img``
    (Pillow's resize to the same size is a copy and the centre crop is the
    whole image).  Other sizes raise: the JAX package resizes them with
    Pillow's bilinear filter, which is not ported."""
    img = read_png(path)
    if img.shape[:2] != (img_size, img_size):
        raise NotImplementedError(
            f"{path}: {img.shape[1]}x{img.shape[0]} pixels; only {img_size}x{img_size} "
            "images are read: the PIL bilinear resize of the JAX package's "
            "read_img is not ported")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(IMG_MEAN, np.float32)) / np.asarray(IMG_STD, np.float32)
    return arr[None]
