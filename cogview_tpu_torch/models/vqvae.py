"""VQ-VAE image tokenizer (twin of cogview_tpu/models/vqvae.py).

Released cogview configuration: channel 512, embed_dim 256, n_embed 8192;
the encoder is three stride-2 4x4 convs and a 1x1 projection, the decoder
three stride-2 4x4 transposed convs and a 1x1 projection.  Parameters use
PyTorch's layouts, convs OIHW and transposed convs ``[in, out, kh, kw]``;
the codebook keeps the JAX package's ``[embed_dim, n_embed]``.
Activations are NCHW inside; the public functions take and return the JAX
package's NHWC images and features.

The JAX package lowers ConvTranspose2d(4, 2, 1) to a sub-pixel conv because
its TPU backend runs input-dilated convs slowly; here it is
``conv_transpose2d``.  ``img2code`` and ``code2img`` take the JAX
package's ``dtype=`` option (that half's parameters and the image or the
codebook cast, e.g. to bfloat16; the codebook argmin stays float32).

The training half: the straight-through quantizer with its commitment
term, the gumbel-softmax quantizer (soft and hard) and the EMA codebook
update (decay 0.99, Laplace-smoothed cluster sizes, float32).  The gumbel
noise comes from a ``torch.Generator``, which cannot draw
``jax.random.gumbel``'s numbers: the parity tests hand the JAX draw over as
``noise=``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VQVAEConfig
from ..utils.image_errors import UnsupportedImageError
from ..utils.image_formats import decode_image  # noqa: F401 (the readers' entry point)

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


def with_ema_buffers(params: Params) -> Params:
    """Add the codebook's EMA training state as the JAX package's
    ``init_params`` makes it: ``cluster_size`` zeros and ``embed_avg`` a
    copy of ``embed``."""
    embed = params["quantize"]["embed"]
    quant = {"embed": embed, "cluster_size": torch.zeros(embed.shape[1], device=embed.device),
             "embed_avg": embed.clone()}
    return {**params, "quantize": quant}


def _cast(tree: Params, dtype) -> Params:
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def tree_to(tree: Params, device) -> Params:
    """Every tensor of a params tree moved to ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


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
def img2code(params: Params, img: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Normalized image batch [b, h, w, 3] -> flat codes [b, (h/8)*(w/8)]
    int64; float32 convs (TF32 must be off on a card, see ops/precision.py).
    ``dtype=torch.bfloat16`` runs the encoder in bfloat16: a few codes near
    quantization ties flip against float32."""
    enc = params["encoder"]
    img = img.float()
    if dtype is not None:
        enc, img = _cast(enc, dtype), img.to(dtype)
    z = encode_features({"encoder": enc}, img)
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
def code2img(params: Params, codes: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """codes [b, s*s] or [b, s, s] -> de-normalized float32 image
    [b, 8s, 8s, 3] (NHWC, as the JAX package returns it).
    ``dtype=torch.bfloat16`` runs the decoder and the de-normalization in
    bfloat16."""
    if codes.ndim == 2:
        side = math.isqrt(codes.shape[-1])
        codes = codes.reshape(codes.shape[0], side, side)
    dec, embed = params["decoder"], params["quantize"]["embed"]
    if dtype is not None:
        dec, embed = _cast(dec, dtype), embed.to(dtype)
    quant = lookup_code(embed, codes.long())  # [b, s, s, D]
    out = decode_features({"decoder": dec}, quant.permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1)
    mean = torch.tensor(IMG_MEAN, dtype=out.dtype, device=out.device)
    std = torch.tensor(IMG_STD, dtype=out.dtype, device=out.device)
    return (out * std + mean).float()


def decode_nhwc(params: Params, quant: torch.Tensor) -> torch.Tensor:
    """quant [b, s, s, D] (NHWC) -> decoder output [b, 8s, 8s, 3] (NHWC), as
    the JAX package's ``decode_features``."""
    return decode_features(params, quant.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def quantize_st(params: Params, z: torch.Tensor, train: bool = False):
    """Straight-through quantization -> (quantized, codes, commitment_mse,
    quantize state): ``z + (quant - z).detach()`` passes the gradient to the
    encoder unchanged, and the commitment term
    ``mean((quant.detach() - z) ** 2)`` pulls z to its code.  With
    ``train=True`` the state is the EMA update on this batch."""
    q = params["quantize"]
    codes = nearest_code(q["embed"], z)
    quant = lookup_code(q["embed"], codes)
    diff = torch.mean((quant.detach() - z) ** 2)
    quant_st = z + (quant - z).detach()
    if not train:
        return quant_st, codes, diff, q
    return quant_st, codes, diff, ema_codebook_update(q, z, codes)


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), as
    ``jax.random.gumbel`` computes it (not its numbers)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def quantize_gumbel(params: Params, z: torch.Tensor, generator=None, temperature=1.0,
                    hard: bool = False, noise=None):
    """Gumbel-softmax relaxed quantization -> (quantized [..., D], KL(q ||
    uniform), codes [...]).  logits = -||z - e_j||^2 in float32; soft mode
    returns the softmax-weighted codebook mixture, hard mode the plain
    lookup through a detached one-hot (the encoder then learns only through
    the KL term).  ``noise`` [N, K] replaces the draw from ``generator``."""
    q = params["quantize"]
    embed = q["embed"].float()  # [D, K]
    flat = z.reshape(-1, z.shape[-1]).float()
    scores = flat @ embed
    dist = (flat ** 2).sum(dim=-1, keepdim=True) - 2.0 * scores + (embed ** 2).sum(dim=0)[None, :]
    logits = -dist
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    y_soft = torch.softmax((logits + noise) / temperature, dim=-1)
    codes = torch.argmax(y_soft, dim=-1)
    qy = torch.softmax(logits, dim=-1)
    kl = torch.mean(torch.sum(qy * torch.log(qy * embed.shape[1] + 1e-20), dim=-1))
    if hard:
        y = F.one_hot(codes, embed.shape[1]).to(y_soft.dtype)
    else:
        y = y_soft
    quant = y @ embed.t()
    return quant.reshape(z.shape).to(z.dtype), kl, codes.reshape(z.shape[:-1])


@torch.no_grad()
def codebook_stats(z: torch.Tensor, codes: torch.Tensor, n_embed: int):
    """The EMA update's sufficient statistics: the count of each code and
    the sum of the features assigned to it ([D, K], a one-hot matmul as in
    the JAX package)."""
    flat = z.detach().reshape(-1, z.shape[-1])
    onehot = F.one_hot(codes.reshape(-1), n_embed).to(flat.dtype)
    return onehot.sum(dim=0), (flat.t() @ onehot).float()


@torch.no_grad()
def apply_ema(q: Params, onehot_sum, embed_sum, decay: float = 0.99, eps: float = 1e-5) -> Params:
    """Exponential moving averages of the counts and sums, and the codebook
    from them with Laplace-smoothed counts ``(n_j + eps) / (n + K eps) n``;
    float32."""
    cluster_size = q["cluster_size"] * decay + onehot_sum.float() * (1 - decay)
    embed_avg = q["embed_avg"] * decay + embed_sum * (1 - decay)
    n = torch.sum(cluster_size)
    n_embed = cluster_size.shape[0]
    smoothed = (cluster_size + eps) / (n + n_embed * eps) * n
    embed = embed_avg / smoothed[None, :]
    return {"embed": embed, "cluster_size": cluster_size, "embed_avg": embed_avg}


def ema_codebook_update(q: Params, z: torch.Tensor, codes: torch.Tensor) -> Params:
    onehot_sum, embed_sum = codebook_stats(z, codes, q["embed"].shape[1])
    return apply_ema(q, onehot_sum, embed_sum)


# Pillow's fixed-point precision for 8-bit images (libImaging/Resample.c)
PRECISION_BITS = 32 - 8 - 2


def _triangle(t: float) -> float:
    return 1.0 - t if t < 1.0 else 0.0


def _bicubic(t: float) -> float:
    """Pillow's bicubic convolution filter, a = -0.5 (t = |x|)."""
    a = -0.5
    if t < 1.0:
        return ((a + 2.0) * t - (a + 3.0)) * t * t + 1
    if t < 2.0:
        return (((t - 5) * t + 8) * t - 4) * a
    return 0.0


# Pillow's filters: (the kernel of |x|, its support)
BILINEAR, BICUBIC = (_triangle, 1.0), (_bicubic, 2.0)


def _resample_coeffs(in_size: int, out_size: int, filt=BILINEAR):
    """Pillow's ``precompute_coeffs`` for ``filt`` over the whole axis, then
    ``normalize_coeffs_8bpc`` -> (first input index [out], integer weights
    [out, ksize]; a weight past a row's support is 0).  The support widens
    by the downscale factor, so a reduction antialiases.  Python floats are
    the C code's doubles, and the sums run in its order."""
    kernel, base = filt
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    inv = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        count = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel(abs((x + xmin - center + 0.5) * inv)) for x in range(count)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            v = v / total if total != 0.0 else v
            kk[xx, x] = int((0.5 if v >= 0 else -0.5) + v * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, filt=BILINEAR) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of a uint8 image:
    sums of pixel x integer weight from half a unit, then clipped to
    [0, 255] and shifted back."""
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    first, kk = _resample_coeffs(in_size, out_size, filt)
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


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[h, w, 3] uint8 -> [height, width, 3] uint8, equal to Pillow's
    ``Image.resize((width, height))`` on an RGB image, whose default filter
    is BICUBIC."""
    return _resample_axis(_resample_axis(img, width, 1, BICUBIC), height, 0, BICUBIC)


def image_from_array(a: np.ndarray) -> np.ndarray:
    """A uint8 array as Pillow's ``Image.fromarray(a).convert("RGB")``:
    [h, w] is gray ("L"), [h, w, 2] gray and alpha, [h, w, 3] RGB and
    [h, w, 4] RGBA; the alpha is dropped."""
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (2, 3, 4)):
        raise UnsupportedImageError(
            f"an image array of shape {a.shape} and dtype {a.dtype} is not read by this "
            "package (uint8 [h, w], [h, w, 2], [h, w, 3] or [h, w, 4])")
    if a.ndim == 2 or a.shape[2] == 2:
        gray = a if a.ndim == 2 else a[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(a[..., :3])


def to_model_input(img: np.ndarray, img_size: int = 256) -> np.ndarray:
    """[h, w, 3] uint8 -> the normalized float32 [img_size, img_size, 3]:
    the short side resized to ``img_size`` with Pillow's bilinear filter
    (:func:`resize_bilinear`), the centre crop, then the dataset's mean and
    std."""
    h, w = img.shape[:2]
    if w < h:
        nw, nh = img_size, max(1, round(h * img_size / w))
    else:
        nw, nh = max(1, round(w * img_size / h)), img_size
    img = resize_bilinear(img, nw, nh)
    left, top = (nw - img_size) // 2, (nh - img_size) // 2
    img = img[top:top + img_size, left:left + img_size]
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - np.asarray(IMG_MEAN, np.float32)) / np.asarray(IMG_STD, np.float32)


def read_img(path: str, img_size: int = 256) -> np.ndarray:
    """An image file (:func:`decode_image`) -> the normalized float32 image [1, img_size,
    img_size, 3], as the JAX package's ``read_img``: the short side resized
    to ``img_size`` with Pillow's bilinear filter (:func:`resize_bilinear`),
    then the centre crop."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        img = decode_image(data)
    except ValueError as e:
        raise type(e)(f"{path}: {e}") from None
    return to_model_input(img, img_size)[None]
