"""Causal + prefix flash attention, forward and backward (twin of
cogview_tpu/ops/flash_attention.py).

Masking is the reference's: a key is visible to a query iff
``kpos <= qpos or kpos < sep`` (a bidirectional prefix of ``sep``
positions), and a masked logit is exactly -10000, not -inf.  Logits are
``(q . k) * (1 / sqrt(D))``: the scale is applied after the dot, where
``dense_attention`` pre-scales q.  Dots take the input dtype's values with
float32 sums; the softmax is float32.

Attention-probability dropout keeps the score element (b, n, qpos, kpos)
iff ``hash_u32(seed, qpos, kpos, b * N + n) >= round(rate * 2^32)``
(ops/hash_prng.py), so the mask depends on global coordinates only and the
backward recomputes it.  A shard of the batch and heads (tensor or data
parallelism) passes its ``batch_offset`` b0, ``head_offset`` n0 and the
global head count N: its element (b, n) hashes ``(b0 + b) * N + n0 + n``,
the JAX package's global coordinates under GSPMD, so its mask is the
matching block of the unsharded mask.  ``l`` sums the softmax mass before dropout; kept
probabilities are scaled by ``1 / (1 - rate)`` and cast to v's dtype before
the product with V.

:func:`flash_attention` is the entry point and returns ``(o [B, S, N, D] in
q's dtype, lse [B, N, S] float32)`` with ``lse = m + log(l)``.  It is a
``torch.autograd.Function``: the forward saves q, k, v, o and lse; the
backward computes ``delta = rowsum(dO * O)`` in float32 and then dq through
:func:`flash_bwd_dq` and dk, dv through :func:`flash_bwd_dkv`, the two passes
of the JAX package's custom VJP.  lse has no gradient.

Each of the three passes launches a hand-written kernel of
csrc/flash_attention.cuh on a CUDA tensor (bfloat16 on the tensor cores,
float32 on the CUDA cores), or raises; on a CPU tensor it runs
its plain PyTorch version (``flash_attention_reference``,
``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``).  ``.launches`` on
each wrapper counts kernel launches, ``.calls`` on each plain version counts
its calls.

The kernels take any head dim D up to 256: each is built for the tile
widths of ``TILE_WIDTHS`` and runs D in the narrowest that holds it
(:func:`tile_width`), its columns past D zero; the wider widths live in
libraries of their own (``LIBRARIES``), built beside the first.  Operands
whose pointers, strides or D values are not 16-byte multiples are copied
with narrower copies (:func:`copy_width`), never padded or refused.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._kernels import launch
from .hash_prng import hash_u32

MASK_VALUE = -10000.0
# the tile widths the CUDA kernels are built for, by library: each library's
# source (csrc/<library>.cu) lists its own in with_tile_width.  The float32
# kernels' column layout takes multiples of 32 (and 16).  EXACT_LIBRARY
# holds the kernels for a head dim equal to its tile width with 16-byte
# copies, D and the copy width folded to constants (the code D = 16, 32, 64
# and 128 ran before); the others take D and the copy width at run time.
# The libraries build side by side, so no one nvcc holds them all.  The
# plain versions take any head dim.
LIBRARIES = {"flash_attention": (16, 32, 64, 128),
             "flash_attention_16_128": (16, 32, 64, 128),
             "flash_attention_96_160": (96, 160),
             "flash_attention_192_224": (192, 224),
             "flash_attention_256": (256,)}
EXACT_LIBRARY = "flash_attention"
TILE_WIDTHS = tuple(sorted({w for widths in LIBRARIES.values() for w in widths}))


def tile_width(head_dim: int) -> int:
    """The narrowest tile width of the CUDA kernels that holds ``head_dim``
    columns.  Past 256 it raises NotImplementedError: wgmma's widest
    product is 256 columns."""
    for width in TILE_WIDTHS:
        if head_dim <= width:
            return width
    raise NotImplementedError(f"head_dim {head_dim}: the CUDA flash kernels take head dims "
                              f"up to {TILE_WIDTHS[-1]}")


def _library(head_dim: int, tile: int, width: int) -> str:
    """The library whose kernels run a call at ``head_dim`` in ``tile``
    with copies of ``width`` bytes."""
    if head_dim == tile and width == 16 and tile in LIBRARIES[EXACT_LIBRARY]:
        return EXACT_LIBRARY
    return next(name for name, widths in LIBRARIES.items()
                if name != EXACT_LIBRARY and tile in widths)


def copy_width(tensors, head_dim: int) -> int:
    """Bytes of one global copy the kernels use on these [B, S, N, D]
    operands: the widest of 16, 8, 4 and 2 that divides every pointer, every
    batch and sequence stride and a head's D values, in bytes (bfloat16 at
    D = 100: 200-byte heads, 8)."""
    es = tensors[0].element_size()
    width = 16
    for t in tensors:
        for nbytes in (t.data_ptr(), t.stride(0) * es, t.stride(1) * es, head_dim * es):
            while nbytes % width:
                width //= 2
    return width


def _rate_threshold(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _keep_mask(seed: int, bn: torch.Tensor, sq: int, sk: int, rate: float) -> torch.Tensor:
    """[..., sq, sk] bool keep mask for (b * N + n) coordinates ``bn``
    (a tensor broadcast against [sq, sk])."""
    qpos = torch.arange(sq, device=bn.device)[:, None]
    kpos = torch.arange(sk, device=bn.device)[None, :]
    return hash_u32(seed, qpos, kpos, bn) >= _rate_threshold(rate)


def dropout_keep_reference(seed: int, b: int, n: int, num_heads: int, sq: int,
                           sk: int, rate: float, device=None) -> torch.Tensor:
    """[sq, sk] bool keep mask of head (b, n), identical to the kernels'."""
    bn = torch.tensor(b * num_heads + n, dtype=torch.int64, device=device)
    return _keep_mask(seed, bn, sq, sk, rate)


def _masked_logits(q: torch.Tensor, k: torch.Tensor, sep: int) -> torch.Tensor:
    """[B, N, S, S] float32 logits, scaled after the dot, masked to -10000."""
    S, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    visible = (pos[None, :] <= pos[:, None]) | (pos[None, :] < sep)
    return torch.where(visible, s, MASK_VALUE)


def _drop(p: torch.Tensor, rate: float, seed: Optional[int], offsets=(0, 0, None)
          ) -> torch.Tensor:
    """Kept probabilities of [B, N, S, S] ``p``, scaled by 1 / (1 - rate);
    ``offsets`` is (batch offset, head offset, global heads or None)."""
    if rate <= 0.0:
        return p
    B, N, S = p.shape[0], p.shape[1], p.shape[2]
    b0, n0, n_global = offsets
    b = b0 + torch.arange(B, device=p.device)
    n = n0 + torch.arange(N, device=p.device)
    bn = (b[:, None] * (n_global or N) + n[None, :]).reshape(B, N, 1, 1)
    return torch.where(_keep_mask(seed, bn, S, S, rate), p / (1.0 - rate), 0.0)


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, N, D] bfloat16 or float32
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    offsets=(0, 0, None),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel -> (o, lse).  ``offsets``
    is (batch offset, head offset, global heads or None) of a shard.

    One softmax over all keys replaces the kernel's per-tile online softmax
    (equal up to float32 rounding; with bfloat16 v the kernel rounds
    probabilities scaled by its running maximum, this version by the row's
    maximum)."""
    flash_attention_reference.calls += 1
    s = _masked_logits(q, k, sep)
    m = s.amax(dim=-1, keepdim=True)  # [B, N, S, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = _drop(p, dropout_rate, dropout_seed, offsets)
    acc = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


flash_attention_reference.calls = 0


def _bwd_terms(q, k, v, do, lse, delta, sep, rate, seed, offsets):
    """(pd, ds) [B, N, S, S] float32: the dropped probabilities and the
    logits' gradient, as both backward kernels form them."""
    p = torch.exp(_masked_logits(q, k, sep) - lse[..., None])
    dp = torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())
    pd = _drop(p, rate, seed, offsets)
    ds = (pd * dp - p * delta[..., None]) * (1.0 / math.sqrt(q.shape[3]))
    return pd, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, sep: int = 0,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           offsets=(0, 0, None)) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds . k, with ds cast to
    k's dtype, float32 sums, dq in q's dtype.  ``lse`` and ``delta`` are
    [B, N, S] float32."""
    flash_bwd_dq_reference.calls += 1
    _, ds = _bwd_terms(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed, offsets)
    return torch.einsum("bnqk,bknd->bqnd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


flash_bwd_dq_reference.calls = 0


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, sep: int = 0,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None, offsets=(0, 0, None)
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dv = pd^T . dO with pd cast
    to dO's dtype, dk = ds^T . q with ds cast to q's dtype, float32 sums."""
    flash_bwd_dkv_reference.calls += 1
    pd, ds = _bwd_terms(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed, offsets)
    dv = torch.einsum("bnqk,bqnd->bknd", pd.to(do.dtype).float(), do.float()).to(v.dtype)
    dk = torch.einsum("bnqk,bqnd->bknd", ds.to(q.dtype).float(), q.float()).to(k.dtype)
    return dk, dv


flash_bwd_dkv_reference.calls = 0


# --------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------- #


def _check_operand(name: str, t: torch.Tensor, shape, dtype, device, width: int) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {shape} {dtype} on {device}")
    # the kernels take batch and sequence strides; a head row must be
    # contiguous, and its pointer and strides multiples of the copy width
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: heads and head dims must be contiguous, "
                         f"strides {t.stride()}")
    es = t.element_size()
    if t.data_ptr() % width or t.stride(0) * es % width or t.stride(1) * es % width:
        raise ValueError(f"{name}: pointer or strides not {width}-byte aligned, "
                         f"strides {t.stride()}")


def _cuda_operands(*named):
    """Validate [B, S, N, D] operands of one launch -> (B, S, N, D, [D, tile
    width, copy width, flat strides])."""
    q = named[0][1]
    if q.ndim != 4:
        raise ValueError(f"q must be [B, S, N, D], got {tuple(q.shape)}")
    B, S, N, D = q.shape
    tile = tile_width(D)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32")
    width = copy_width([t for _, t in named], D)
    strides = []
    for name, t in named:
        _check_operand(name, t, (B, S, N, D), q.dtype, q.device, width)
        strides += [t.stride(0), t.stride(1)]
    return B, S, N, D, [D, tile, width, *strides]


def _check_rows(name: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                         f"contiguous {shape} float32 on {device}")


def _dropout_args(D: int, N: int, sep: int, rate: float, seed: Optional[int], offsets):
    b0, n0, n_global = offsets
    return (int(sep), 1.0 / math.sqrt(D), int(seed or 0) & 0xFFFFFFFF,
            _rate_threshold(rate), 1.0 - rate, int(rate > 0.0), int(b0), int(n0),
            int(n_global or N))


def _flash_fwd(q, k, v, sep, rate, seed, offsets=(0, 0, None)):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sep, rate, seed, offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.shape[0] == 0:  # a data rank's empty shard of a pipeline microbatch: no grid
        _, S, N, _ = q.shape
        return torch.empty_like(q), q.new_empty((0, N, S), dtype=torch.float32)
    B, S, N, D, layout = _cuda_operands(("q", q), ("k", k), ("v", v))
    o = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    launch(_library(*layout[:3]), "flash_attention_fwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
           int(q.dtype == torch.bfloat16), B, S, N, *layout,
           *_dropout_args(D, N, sep, rate, seed, offsets))
    flash_attention.launches += 1
    return o, lse


def _bwd_launch_args(q, k, v, do, lse, delta):
    B, S, N, D, layout = _cuda_operands(("q", q), ("k", k), ("v", v), ("do", do))
    _check_rows("lse", lse, (B, N, S), q.device)
    _check_rows("delta", delta, (B, N, S), q.device)
    return B, S, N, D, layout


def flash_bwd_dq(q, k, v, do, lse, delta, sep: int = 0, *, dropout_rate: float = 0.0,
                 dropout_seed: Optional[int] = None, offsets=(0, 0, None)) -> torch.Tensor:
    """dq [B, S, N, D] of the backward: the dq kernel on a CUDA tensor (or
    raises), its plain version on a CPU tensor.  ``do`` is dO, ``lse`` and
    ``delta`` are [B, N, S] float32; ``offsets`` as :func:`flash_attention`'s
    (batch offset, head offset, global heads or None)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed,
                                      offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    if q.shape[0] == 0:  # an empty shard (an empty dO may have any strides)
        return torch.empty_like(q)
    do = do.contiguous()
    B, S, N, D, layout = _bwd_launch_args(q, k, v, do, lse, delta)
    dq = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    launch(_library(*layout[:3]), "flash_attention_bwd_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), int(q.dtype == torch.bfloat16), B, S, N,
           *layout, *_dropout_args(D, N, sep, dropout_rate, dropout_seed, offsets))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, sep: int = 0, *, dropout_rate: float = 0.0,
                  dropout_seed: Optional[int] = None, offsets=(0, 0, None)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, N, D] of the backward: the dk/dv kernel on a CUDA
    tensor (or raises), its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, sep, dropout_rate, dropout_seed,
                                       offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    if q.shape[0] == 0:  # an empty shard
        return torch.empty_like(k), torch.empty_like(v)
    do = do.contiguous()
    B, S, N, D, layout = _bwd_launch_args(q, k, v, do, lse, delta)
    dk = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    launch(_library(*layout[:3]), "flash_attention_bwd_dkv", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
           B, S, N, *layout, *_dropout_args(D, N, sep, dropout_rate, dropout_seed, offsets))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom VJP: forward kernel, then the dq and dk/dv
    passes from the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, sep, rate, seed, offsets):
        o, lse = _flash_fwd(q, k, v, sep, rate, seed, offsets)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sep, ctx.rate, ctx.seed, ctx.offsets = sep, rate, seed, offsets
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O), float32, outside the kernels -> [B, N, S]
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        kw = dict(dropout_rate=ctx.rate, dropout_seed=ctx.seed, offsets=ctx.offsets)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.sep, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.sep, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, N, D]
    k: torch.Tensor,
    v: torch.Tensor,
    sep: int = 0,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    batch_offset: int = 0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention -> (o [B, S, N, D] in q.dtype, lse [B, N, S]), with a
    backward to q, k and v.  A shard of a larger batch and head set passes
    its ``batch_offset``, ``head_offset`` and the global ``num_heads`` for
    the dropout hash (zeros and N: the unsharded call).

    q, k and v may be strided views (the slices of a fused QKV projection):
    the kernels read them through their batch and sequence strides, with no
    copy.  ``dropout_seed`` is a uint32.  A CPU tensor runs the plain
    versions; a CUDA tensor launches the kernels of csrc/flash_attention.cuh
    on the current stream, or raises (a head dim past 256 raises
    NotImplementedError).  There is no fallback."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    offsets = (int(batch_offset), int(head_offset), num_heads)
    return _FlashAttention.apply(q, k, v, int(sep), float(dropout_rate), dropout_seed, offsets)


flash_attention.launches = 0
