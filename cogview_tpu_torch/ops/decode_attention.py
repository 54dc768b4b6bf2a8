"""Single-token decode attention over the int8 window-blocked KV cache.

Twin of cogview_tpu/ops/decode_attention.py.  The cache layout is the JAX
package's, so tests compare cache bytes with no converter:

* data ``[L, NW, B, 2, N, D, W]`` int8 (K at 0, V at 1 on the ``2`` dim),
  NW windows of W = 128 tokens; for each (layer, window, row, K/V, head) the
  ``[D, W]`` block is 8 KB (D = 64) with tokens minor;
* scales ``[L, NW, B, 2, N, W]`` float32, per (head, token), absmax / 127;
* ring ``[L, G, B, N, 2*D]`` float32: the exact K|V columns of the last
  G = 8 positions, K in lanes [0, D) and V in [D, 2D).

Indexing a layer (``kv[li]``) is a zero-copy view, so the functions here take
per-layer views instead of a runtime layer index.  The JAX package donates
its cache buffers and gets the updated arrays back; here the cache is
updated in place, which is what the donation achieved.

Decode step at absolute position ``index`` (rem = index % G,
c0 = index - rem): attend the int8 sealed prefix [0, c0), K scale on the
logits and V scale on the probabilities, plus the exact ring slots g <= rem
(positions c0 + g).  Masked sealed logits are exactly -10000; logits are
scaled by 1/sqrt(D).  On seal steps (rem == G - 1) the G ring columns are
quantized (absmax times float32(1/127), round half to even) into window
c0 // W, lanes
[c0 % W, c0 % W + G); no other byte changes.  Other steps leave the cache
untouched.

:func:`decode_attention_quant` is the entry point: on a CUDA tensor it
launches the hand-written kernel (csrc/decode_attention.cu), on a CPU tensor
it runs :func:`decode_attention_quant_reference`, the plain PyTorch version.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

MASK_VALUE = -10000.0
WRITE_WINDOW = 128  # tokens per cache window
SEAL_GROUP = 8  # decode steps per seal; the last <= 8 tokens ride the ring


def pad_cache_len(max_len: int) -> int:
    """Cache length rounded up to a WRITE_WINDOW multiple."""
    return -(-max_len // WRITE_WINDOW) * WRITE_WINDOW


# ------------------------------------------------------------------ #
# quantization and the window-blocked layout (prefill path, tests)
# ------------------------------------------------------------------ #


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefill scales: max(absmax over ``dim``, 1e-8) / 127 with an IEEE
    division, as the JAX package's ``quantize_kv`` computes them.  PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal instead;
    a 0-d tensor divisor keeps the true division."""
    amax = torch.clamp(x.abs().amax(dim=dim), min=1e-8)
    return amax / amax.new_full((), 127.0)


def _seal_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Seal scales: max(absmax over ``dim``, 1e-8) times float32(1/127).  The
    JAX kernel writes ``/ 127.0`` but XLA compiles its seal to a multiply by
    the float32 reciprocal (checked bit for bit on the CPU), which can differ
    from the division in the last bit; the CUDA kernel does the same."""
    amax = torch.clamp(x.abs().amax(dim=dim), min=1e-8)
    return amax * amax.new_full((), 1.0 / 127.0)


def quantize_kv(cols: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(head, token) absmax int8 quantization of K or V columns.

    cols [B, H, S] -> (int8 [B, N, D, S], float32 scales [B, N, S]).  Scales
    carry the 1/127 factor; rounding is half to even, as ``jnp.round``."""
    B, H, S = cols.shape
    D = H // num_heads
    c = cols.reshape(B, num_heads, D, S).float()
    s = _absmax_scale(c, 2)
    q = torch.round(c / s[:, :, None, :])
    return torch.clamp(q, -127, 127).to(torch.int8), s


def dequantize_kv(q8: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """[B, N, D, T] int8 + [B, N, T] scales -> [B, N, D, T] floats."""
    return (q8.float() * scales[:, :, None, :]).to(dtype)


def _window_spans(index: int, S: int, W: int):
    """(window, lane_lo, lane_hi, col_lo, col_hi) pieces of slots
    [index, index + S) cut at window boundaries."""
    pos = index
    while pos < index + S:
        w, lo = divmod(pos, W)
        hi = min(W, lo + index + S - pos)
        yield w, lo, hi, pos - index, pos - index + hi - lo
        pos += hi - lo


def scatter_kv_columns(cache_l: torch.Tensor, kcols: torch.Tensor,
                       vcols: torch.Tensor, index: int) -> None:
    """Write K/V columns [B, N, D, S] into one layer's window-blocked cache
    [NW, B, 2, N, D, W] at slots [index, index + S), in place."""
    W = cache_l.shape[-1]
    for w, lo, hi, a, b in _window_spans(index, kcols.shape[3], W):
        cache_l[w, :, 0, :, :, lo:hi] = kcols[..., a:b]
        cache_l[w, :, 1, :, :, lo:hi] = vcols[..., a:b]


def scatter_kv_scales(scales_l: torch.Tensor, kscols: torch.Tensor,
                      vscols: torch.Tensor, index: int) -> None:
    """Same for one layer's scales [NW, B, 2, N, W]; cols [B, N, S]."""
    W = scales_l.shape[-1]
    for w, lo, hi, a, b in _window_spans(index, kscols.shape[2], W):
        scales_l[w, :, 0, :, lo:hi] = kscols[..., a:b]
        scales_l[w, :, 1, :, lo:hi] = vscols[..., a:b]


def gather_kv(cache_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer [NW, B, 2, N, D, W] -> (K [B, N, D, NW*W], V likewise)."""
    NW, B, _, N, D, W = cache_l.shape
    cols = cache_l.permute(1, 2, 3, 4, 0, 5).reshape(B, 2, N, D, NW * W)
    return cols[:, 0], cols[:, 1]


def gather_kv_scales(scales_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer [NW, B, 2, N, W] -> (K scales [B, N, NW*W], V scales)."""
    NW, B, _, N, W = scales_l.shape
    cols = scales_l.permute(1, 2, 3, 0, 4).reshape(B, 2, N, NW * W)
    return cols[:, 0], cols[:, 1]


def fused_from_columns(kcol: torch.Tensor, vcol: torch.Tensor) -> torch.Tensor:
    """Column-form K and V [L, B, N, D, T] -> [L, NW, B, 2, N, D, W]; scale
    pairs [L, B, N, T] -> [L, NW, B, 2, N, W].  Test and tooling helper."""
    W = WRITE_WINDOW
    kv = torch.stack([kcol, vcol], dim=2)
    if kcol.ndim == 5:
        L, B, _, N, D, T = kv.shape
        return kv.reshape(L, B, 2, N, D, T // W, W).permute(
            0, 5, 1, 2, 3, 4, 6).contiguous()
    L, B, _, N, T = kv.shape
    return kv.reshape(L, B, 2, N, T // W, W).permute(0, 4, 1, 2, 3, 5).contiguous()


def columns_from_fused(blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`fused_from_columns` -> (K columns, V columns)."""
    if blk.ndim == 7:
        L, NW, B, _, N, D, W = blk.shape
        col = blk.permute(0, 2, 3, 4, 5, 1, 6).reshape(L, B, 2, N, D, NW * W)
        return col[:, :, 0], col[:, :, 1]
    L, NW, B, _, N, W = blk.shape
    col = blk.permute(0, 2, 3, 4, 1, 5).reshape(L, B, 2, N, NW * W)
    return col[:, :, 0], col[:, :, 1]


def fuse_ring(ring_split: torch.Tensor) -> torch.Tensor:
    """Split ring [L, G, B, 2, N, D] -> the K|V-fused float32 ring
    [L, G, B, N, 2*D].  Test and tooling helper."""
    return torch.cat([ring_split[:, :, :, 0], ring_split[:, :, :, 1]],
                     dim=-1).float().contiguous()


# ------------------------------------------------------------------ #
# decode attention: plain version and the kernel's wrapper
# ------------------------------------------------------------------ #


def _seal(ring_l: torch.Tensor, kv_l: torch.Tensor, scales_l: torch.Tensor,
          c0: int) -> None:
    """Quantize the G ring columns into window c0 // W, lanes
    [c0 % W, c0 % W + G), in place (the kernel's seal, in PyTorch)."""
    G, B, N, D2 = ring_l.shape
    D, W = D2 // 2, kv_l.shape[-1]
    w, lane0 = divmod(c0, W)
    for t in (0, 1):
        col = ring_l[..., t * D:(t + 1) * D]  # [G, B, N, D]
        sc = _seal_scale(col, -1)  # [G, B, N]
        q = torch.round(col / sc[..., None]).to(torch.int8)
        kv_l[w, :, t, :, :, lane0:lane0 + G] = q.permute(1, 2, 3, 0)
        scales_l[w, :, t, :, lane0:lane0 + G] = sc.permute(1, 2, 0)


def decode_attention_quant_reference(
    q: torch.Tensor,  # [B, N, D] bfloat16 or float32
    ring_l: torch.Tensor,  # [G, B, N, 2*D] float32
    kv_l: torch.Tensor,  # [NW, B, 2, N, D, W] int8
    scales_l: torch.Tensor,  # [NW, B, 2, N, W] float32
    index: int,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel -> ctx [B, N, D] in
    q.dtype; seals into ``kv_l``/``scales_l`` in place on seal steps.

    Rounding points follow the JAX kernel: with bfloat16 q the QK product
    takes bf16(q) and the logits are multiplied by ``ks * scale``, and the
    PV operand is bf16(p * vs); with float32 q, q is scaled first.  The ring
    epilogue is float32 throughout.  One softmax over all slots replaces the
    kernel's per-window online softmax (equal up to float32 rounding)."""
    decode_attention_quant_reference.calls += 1
    NW, B, _, N, D, W = kv_l.shape
    G = ring_l.shape[0]
    rem = index % G
    c0 = index - rem
    swl = max(-(-c0 // W), 1)  # windows the kernel streams
    scale = 1.0 / math.sqrt(D)
    bf = q.dtype == torch.bfloat16

    win = kv_l[:swl].permute(1, 2, 3, 4, 0, 5).reshape(B, 2, N, D, swl * W)
    sw = scales_l[:swl].permute(1, 2, 3, 0, 4).reshape(B, 2, N, swl * W)
    k8, v8 = win[:, 0].float(), win[:, 1].float()  # [B, N, D, T]
    ks, vs = sw[:, 0], sw[:, 1]  # [B, N, T]
    q32 = q.float()
    qs = q32 * scale
    if bf:
        s = torch.einsum("bnd,bndt->bnt", q32, k8) * (ks * scale)
    else:
        s = torch.einsum("bnd,bndt->bnt", qs, k8) * ks
    kpos = torch.arange(swl * W, device=q.device)
    s = torch.where(kpos < c0, s, MASK_VALUE)

    ring_k, ring_v = ring_l[..., :D], ring_l[..., D:]  # [G, B, N, D]
    sg = torch.einsum("bnd,gbnd->bng", qs, ring_k)
    sg = torch.where(torch.arange(G, device=q.device) <= rem, sg, -1e30)

    m = torch.maximum(s.amax(dim=-1), sg.amax(dim=-1))[..., None]  # [B, N, 1]
    p = torch.exp(s - m)
    pg = torch.exp(sg - m)
    l = p.sum(dim=-1) + pg.sum(dim=-1)  # [B, N]
    pv = p * vs
    if bf:
        pv = pv.to(torch.bfloat16).float()
    acc = torch.einsum("bnt,bndt->bnd", pv, v8)
    acc = acc + torch.einsum("bng,gbnd->bnd", pg, ring_v)
    ctx = (acc / l[..., None]).to(q.dtype)

    if rem == G - 1:
        _seal(ring_l, kv_l, scales_l, c0)
    return ctx


decode_attention_quant_reference.calls = 0


def decode_attention_quant(
    q: torch.Tensor,  # [B, N, D] bfloat16 or float32
    ring_l: torch.Tensor,  # [G, B, N, 2*D] float32
    kv_l: torch.Tensor,  # [NW, B, 2, N, D, W] int8
    scales_l: torch.Tensor,  # [NW, B, 2, N, W] float32
    index: int,
) -> torch.Tensor:
    """Decode attention for one layer -> ctx [B, N, D] in q.dtype.

    ``ring_l`` slot g must hold the exact K|V column of position c0 + g for
    every g <= index % G, the current token included (the caller writes it
    before the call).  On seal steps the cache views are updated in place.

    A CPU tensor runs the plain version.  A CUDA tensor launches the kernel
    of csrc/decode_attention.cu on the current stream, or raises; there is
    no fallback."""
    if q.device.type == "cpu":
        return decode_attention_quant_reference(q, ring_l, kv_l, scales_l, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: unsupported device {q.device}")
    from . import _kernels

    B, N, D = q.shape
    G = ring_l.shape[0]
    if kv_l.ndim != 6 or kv_l.shape[5] != WRITE_WINDOW:
        raise ValueError(f"kv cache layer view must be [NW, B, 2, N, D, 128], got {tuple(kv_l.shape)}")
    NW = kv_l.shape[0]
    if kv_l.shape[4] != D:
        # a packed int4 cache has D/2 bytes per column
        raise NotImplementedError(
            f"cache column width {kv_l.shape[4]} != head_dim {D}: only the "
            "int8 cache has a CUDA kernel so far (int4 is ROADMAP Queue A8)")
    if tuple(kv_l.shape) != (NW, B, 2, N, D, WRITE_WINDOW):
        raise ValueError(f"kv shape {tuple(kv_l.shape)} does not match q {tuple(q.shape)}")
    if tuple(scales_l.shape) != (NW, B, 2, N, WRITE_WINDOW):
        raise ValueError(f"scales shape {tuple(scales_l.shape)}")
    if tuple(ring_l.shape) != (G, B, N, 2 * D) or WRITE_WINDOW % G or 2 * G > WRITE_WINDOW:
        raise ValueError(f"ring shape {tuple(ring_l.shape)}")  # the seal needs 2G threads
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32")
    if (kv_l.dtype, scales_l.dtype, ring_l.dtype) != (torch.int8, torch.float32, torch.float32):
        raise ValueError("cache dtypes must be int8 data, float32 scales and ring")
    if WRITE_WINDOW % D:
        raise ValueError(f"head_dim {D} must divide {WRITE_WINDOW}")
    if index < 0 or index >= NW * WRITE_WINDOW:
        raise ValueError(f"index {index} outside the cache")
    for name, t in (("q", q), ("ring", ring_l), ("kv", kv_l), ("scales", scales_l)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if kv_l.data_ptr() % 16:
        raise ValueError("kv cache view must be 16-byte aligned")

    ctx = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels.lib().decode_attention_int8(
            q.data_ptr(), int(q.dtype == torch.bfloat16), ring_l.data_ptr(),
            kv_l.data_ptr(), scales_l.data_ptr(), ctx.data_ptr(),
            B, N, D, NW, G, int(index), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_int8 launch failed: CUDA error {err}")
    decode_attention_quant.launches += 1
    return ctx


decode_attention_quant.launches = 0
