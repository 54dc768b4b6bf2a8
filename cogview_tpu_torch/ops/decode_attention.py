"""Single-token decode attention over the int8 or int4 window-blocked KV
cache.

Twin of cogview_tpu/ops/decode_attention.py.  The cache layout is the JAX
package's, so tests compare cache bytes with no converter:

* data ``[L, NW, B, 2, N, Dc, W]`` int8 (K at 0, V at 1 on the ``2`` dim),
  NW windows of W = 128 tokens; for each (layer, window, row, K/V, head) the
  ``[Dc, W]`` block has tokens minor.  The int8 cache has Dc = D (8 KB at
  D = 64); the int4 cache packs two values a byte, Dc = D / 2 (4 KB): byte
  (d2, t) holds row d2 in its high nibble (signed, [-7, 7]) and row
  d2 + D/2 in its low nibble, stored plus 8;
* scales ``[L, NW, B, 2, N, W]`` float32, per (head, token): absmax / 127
  (int8) or absmax / 7 (int4);
* ring ``[L, G, B, N, 2*D]`` float32: the exact K|V columns of the last
  G = 8 positions, K in lanes [0, D) and V in [D, 2D).

Indexing a layer (``kv[li]``) is a zero-copy view, so the functions here take
per-layer views instead of a runtime layer index.  The JAX package donates
its cache buffers and gets the updated arrays back; here the cache is
updated in place, which is what the donation achieved.

Decode step at absolute position ``index`` (rem = index % G,
c0 = index - rem): attend the quantized sealed prefix [0, c0), K scale on
the logits and V scale on the probabilities, plus the exact ring slots
g <= rem (positions c0 + g).  Masked sealed logits are exactly -10000;
logits are scaled by 1/sqrt(D).  On seal steps (rem == G - 1) the G ring
columns are quantized (absmax times float32(1/127), or float32(1/7) with the
values clipped to [-7, 7] and packed; round half to even) into window
c0 // W, lanes [c0 % W, c0 % W + G); no other byte changes.  Other steps
leave the cache untouched.

:func:`decode_attention_quant` is the entry point: on a CUDA tensor it
launches a hand-written kernel of csrc/decode_attention.cu (K1 for the int8
cache, K2 for the int4 cache), on a CPU tensor it runs
:func:`decode_attention_quant_reference`, the plain PyTorch version.  The
kernel splits each (row, head)'s window loop over ``split_plan(B, N, NW)``
blocks and merges their partial softmaxes in the same launch.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ._kernels import launch

MASK_VALUE = -10000.0
WRITE_WINDOW = 128  # tokens per cache window
SEAL_GROUP = 8  # decode steps per seal; the last <= 8 tokens ride the ring
# the head dims the kernels are built for: every D that divides WRITE_WINDOW
# from 8 up (csrc/decode_attention.cu's with_head_dim switch); the plain
# version takes any
HEAD_DIMS = (8, 16, 32, 64, 128)
# blocks a call aims for: four of 128 threads for each of an H100's 132 SMs
SPLIT_TARGET_BLOCKS = 4 * 132


def pad_cache_len(max_len: int) -> int:
    """Cache length rounded up to a WRITE_WINDOW multiple."""
    return -(-max_len // WRITE_WINDOW) * WRITE_WINDOW


def streamed_windows(index: int) -> int:
    """Windows a decode step at ``index`` streams: max(ceil(c0 / W), 1) with
    c0 = index - index % SEAL_GROUP (window 0 even when every column is
    masked)."""
    c0 = index - index % SEAL_GROUP
    return max(-(-c0 // WRITE_WINDOW), 1)


def split_plan(batch: int, heads: int, num_windows: int) -> int:
    """How many blocks share one (row, head)'s window loop in the kernels: as
    many as bring the call to SPLIT_TARGET_BLOCKS blocks, at most one per
    window of the cache.  A function of the shapes alone, never of the
    index, so one grid serves every step: cogview-base (40 heads, 9
    windows) gets 4 splits at batch 4 and 1 from batch 14 up."""
    return max(1, min(num_windows, -(-SPLIT_TARGET_BLOCKS // (batch * heads))))


def split_windows(split: int, splits: int, index: int) -> range:
    """The windows split ``split`` of ``splits`` streams at ``index``:
    every ``splits``-th from ``split`` on, below :func:`streamed_windows`."""
    return range(split, streamed_windows(index), splits)


# ------------------------------------------------------------------ #
# quantization and the window-blocked layout (prefill path, tests)
# ------------------------------------------------------------------ #


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int8 prefill scales: max(absmax over ``dim``, 1e-8) / 127 with an IEEE
    division, as the JAX package's ``quantize_kv`` computes them.  PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal instead;
    a 0-d tensor divisor keeps the true division."""
    amax = torch.clamp(x.abs().amax(dim=dim), min=1e-8)
    return amax / amax.new_full((), 127.0)


def _reciprocal_scale(x: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    """max(absmax over ``dim``, 1e-8) times float32(1 / qmax).  The JAX
    package writes ``/ qmax``, but XLA compiles the interpret-mode seal (int8
    and int4) and the jitted ``quantize_kv4`` to a multiply by the float32
    reciprocal (checked bit for bit on the CPU), which can differ from the
    division in the last bit; the CUDA kernels do the same."""
    amax = torch.clamp(x.abs().amax(dim=dim), min=1e-8)
    return amax * amax.new_full((), 1.0 / qmax)


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


def _unpack4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 bytes -> (hi, lo) float32 nibble values: hi = floor(b / 16)
    and lo = b - 16 hi - 8, the JAX package's float formula.  For every byte
    the packer makes they equal ``b >> 4`` and ``(b & 15) - 8``, which the
    CUDA kernel uses."""
    b = packed.float()
    hi = torch.floor(b * (1.0 / 16.0))
    return hi, b - 16.0 * hi - 8.0


def _pack4(qv: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer-valued float32 in [-7, 7] with D rows on ``dim`` -> int8 bytes
    with D/2 rows: 16 * row d2 + (row d2 + D/2 + 8)."""
    hi, lo = qv.chunk(2, dim=dim)
    return (16.0 * hi + (lo + 8.0)).to(torch.int8)


def quantize_kv4(cols: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(head, token) absmax int4 quantization and nibble packing.

    cols [B, H, S] -> (packed int8 [B, N, D/2, S], float32 scales [B, N, S]).
    Scales are absmax times float32(1/7), as the jitted JAX function computes
    them; values are clip(round(c / s), -7, 7)."""
    B, H, S = cols.shape
    D = H // num_heads
    c = cols.reshape(B, num_heads, D, S).float()
    s = _reciprocal_scale(c, 2, 7.0)
    qv = torch.clamp(torch.round(c / s[:, :, None, :]), -7.0, 7.0)
    return _pack4(qv, 2), s


def dequantize_kv4(q4: torch.Tensor, scales: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """[B, N, D/2, T] packed + [B, N, T] scales -> [B, N, D, T] floats."""
    hi, lo = _unpack4(q4)
    return (torch.cat([hi, lo], dim=2) * scales[:, :, None, :]).to(dtype)


def is_packed(kv_l: torch.Tensor, head_dim: int) -> bool:
    """Whether a cache view [..., Dc, W] is the packed int4 cache
    (Dc = head_dim / 2) rather than the int8 one (Dc = head_dim); any other
    width raises.  The one place the cache's format is read off its shape."""
    Dc = kv_l.shape[-2]
    if Dc != head_dim and 2 * Dc != head_dim:
        raise ValueError(f"cache column width {Dc} is neither head_dim {head_dim} (int8) "
                         f"nor {head_dim // 2} (int4)")
    return Dc != head_dim


def kv_codec(kv_l: torch.Tensor, head_dim: int):
    """The (quantize, dequantize) pair that writes and reads the cache view
    ``kv_l``: :func:`quantize_kv4`/:func:`dequantize_kv4` for the packed
    int4 cache, :func:`quantize_kv`/:func:`dequantize_kv` for int8."""
    if is_packed(kv_l, head_dim):
        return quantize_kv4, dequantize_kv4
    return quantize_kv, dequantize_kv


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
    """Write K/V columns [B, N, Dc, S] into one layer's window-blocked cache
    [NW, B, 2, N, Dc, W] at slots [index, index + S), in place."""
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
    """One layer [NW, B, 2, N, Dc, W] -> (K [B, N, Dc, NW*W], V likewise)."""
    NW, B, _, N, Dc, W = cache_l.shape
    cols = cache_l.permute(1, 2, 3, 4, 0, 5).reshape(B, 2, N, Dc, NW * W)
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
    [c0 % W, c0 % W + G), in place (the kernels' seal, in PyTorch).  A
    packed cache clips to [-7, 7] and packs after quantizing; the lanes
    outside the group keep their bytes."""
    G, B, N, D2 = ring_l.shape
    D, W = D2 // 2, kv_l.shape[-1]
    packed = is_packed(kv_l, D)
    w, lane0 = divmod(c0, W)
    for t in (0, 1):
        col = ring_l[..., t * D:(t + 1) * D]  # [G, B, N, D]
        sc = _reciprocal_scale(col, -1, 7.0 if packed else 127.0)  # [G, B, N]
        q = torch.round(col / sc[..., None])
        q = _pack4(torch.clamp(q, -7.0, 7.0), -1) if packed else q.to(torch.int8)
        kv_l[w, :, t, :, :, lane0:lane0 + G] = q.permute(1, 2, 3, 0)
        scales_l[w, :, t, :, lane0:lane0 + G] = sc.permute(1, 2, 0)


def decode_attention_quant_reference(
    q: torch.Tensor,  # [B, N, D] bfloat16 or float32
    ring_l: torch.Tensor,  # [G, B, N, 2*D] float32
    kv_l: torch.Tensor,  # [NW, B, 2, N, Dc, W] int8, Dc = D or D/2 (packed)
    scales_l: torch.Tensor,  # [NW, B, 2, N, W] float32
    index: int,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernels -> ctx [B, N, D] in
    q.dtype; seals into ``kv_l``/``scales_l`` in place on seal steps.

    Rounding points follow the JAX kernel.  int8 cache: with bfloat16 q the
    QK product takes bf16(q) and the logits are multiplied by
    ``ks * scale``, and the PV operand is bf16(p * vs); with float32 q, q is
    scaled first.  Packed int4 cache: float32 throughout, whatever q's
    dtype; the logits are (q_hi . k_hi + q_lo . k_lo) * ks of the scaled
    query and the context is [pv . v_hi | pv . v_lo].  The ring epilogue is
    float32 throughout.  One softmax over all slots replaces the kernels'
    per-window online softmax (equal up to float32 rounding)."""
    decode_attention_quant_reference.calls += 1
    NW, B, _, N, Dc, W = kv_l.shape
    D = q.shape[2]
    G = ring_l.shape[0]
    rem = index % G
    c0 = index - rem
    swl = max(-(-c0 // W), 1)  # windows the kernel streams
    scale = 1.0 / math.sqrt(D)
    packed = is_packed(kv_l, D)
    bf = q.dtype == torch.bfloat16 and not packed

    win = kv_l[:swl].permute(1, 2, 3, 4, 0, 5).reshape(B, 2, N, Dc, swl * W)
    sw = scales_l[:swl].permute(1, 2, 3, 0, 4).reshape(B, 2, N, swl * W)
    ks, vs = sw[:, 0], sw[:, 1]  # [B, N, T]
    q32 = q.float()
    qs = q32 * scale
    if packed:
        k_hi, k_lo = _unpack4(win[:, 0])  # [B, N, Dc, T]
        s = (torch.einsum("bnd,bndt->bnt", qs[..., :Dc], k_hi)
             + torch.einsum("bnd,bndt->bnt", qs[..., Dc:], k_lo)) * ks
    elif bf:
        s = torch.einsum("bnd,bndt->bnt", q32, win[:, 0].float()) * (ks * scale)
    else:
        s = torch.einsum("bnd,bndt->bnt", qs, win[:, 0].float()) * ks
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
    if packed:
        v_hi, v_lo = _unpack4(win[:, 1])
        acc = torch.cat([torch.einsum("bnt,bndt->bnd", pv, v_hi),
                         torch.einsum("bnt,bndt->bnd", pv, v_lo)], dim=-1)
    else:
        if bf:
            pv = pv.to(torch.bfloat16).float()
        acc = torch.einsum("bnt,bndt->bnd", pv, win[:, 1].float())
    acc = acc + torch.einsum("bng,gbnd->bnd", pg, ring_v)
    ctx = (acc / l[..., None]).to(q.dtype)

    if rem == G - 1:
        _seal(ring_l, kv_l, scales_l, c0)
    return ctx


decode_attention_quant_reference.calls = 0

# the kernels' per-(row, head) split tickets, one zeroed int32 buffer per
# device, made on first use and kept: a CUDA graph that captured a call
# holds its address, and every launch leaves it zeroed
_COUNTER_SLOTS = 1 << 16
_split_counters: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device) -> torch.Tensor:
    buf = _split_counters.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention_quant makes its split counters on the first "
                               "split call on a device: make one outside CUDA-graph capture")
        buf = _split_counters[device] = torch.zeros(_COUNTER_SLOTS, dtype=torch.int32,
                                                    device=device)
    return buf


def decode_attention_quant(
    q: torch.Tensor,  # [B, N, D] bfloat16 or float32
    ring_l: torch.Tensor,  # [G, B, N, 2*D] float32
    kv_l: torch.Tensor,  # [NW, B, 2, N, Dc, W] int8, Dc = D or D/2 (packed)
    scales_l: torch.Tensor,  # [NW, B, 2, N, W] float32
    index: int,
    splits: int | None = None,
) -> torch.Tensor:
    """Decode attention for one layer -> ctx [B, N, D] in q.dtype.

    ``ring_l`` slot g must hold the exact K|V column of position c0 + g for
    every g <= index % G, the current token included (the caller writes it
    before the call).  On seal steps the cache views are updated in place.

    A CPU tensor runs the plain version.  A CUDA tensor launches a kernel
    of csrc/decode_attention.cu on the current stream, chosen by the cache's
    column width ``kv_l.shape[4]``: D is the int8 kernel (K1), D/2 the
    packed int4 kernel (K2).  Anything else raises; there is no fallback.
    The kernel runs ``splits`` blocks per (row, head), :func:`split_plan`
    unless given (tests and measurements pick others), and merges them in
    the same launch; with more than one, the calls on a device must run in
    stream order, as they share its split counters."""
    if q.device.type == "cpu":
        return decode_attention_quant_reference(q, ring_l, kv_l, scales_l, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: unsupported device {q.device}")
    B, N, D = q.shape
    if kv_l.ndim != 6 or kv_l.shape[5] != WRITE_WINDOW:
        raise ValueError(f"kv cache layer view must be [NW, B, 2, N, Dc, 128], got {tuple(kv_l.shape)}")
    NW, Dc = kv_l.shape[0], kv_l.shape[4]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels are built for {HEAD_DIMS}")
    packed = is_packed(kv_l, D)
    fn = "decode_attention_int4" if packed else "decode_attention_int8"
    if tuple(kv_l.shape) != (NW, B, 2, N, Dc, WRITE_WINDOW):
        raise ValueError(f"kv shape {tuple(kv_l.shape)} does not match q {tuple(q.shape)}")
    if tuple(scales_l.shape) != (NW, B, 2, N, WRITE_WINDOW):
        raise ValueError(f"scales shape {tuple(scales_l.shape)}")
    if tuple(ring_l.shape) != (SEAL_GROUP, B, N, 2 * D):
        raise ValueError(f"ring shape {tuple(ring_l.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32")
    if (kv_l.dtype, scales_l.dtype, ring_l.dtype) != (torch.int8, torch.float32, torch.float32):
        raise ValueError("cache dtypes must be int8 data, float32 scales and ring")
    if index < 0 or index >= NW * WRITE_WINDOW:
        raise ValueError(f"index {index} outside the cache")
    for name, t in (("q", q), ("ring", ring_l), ("kv", kv_l), ("scales", scales_l)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("kv cache", kv_l), ("scales", scales_l), ("ring", ring_l)):
        # the kernels copy [Dc, 128] blocks, scale rows and ring slots with
        # 16-byte cp.async; each starts 16-byte aligned when the view does
        if t.data_ptr() % 16:
            raise ValueError(f"{name} view must be 16-byte aligned")
    splits = split_plan(B, N, NW) if splits is None else splits
    if not 1 <= splits <= NW or (splits > 1 and B * N > _COUNTER_SLOTS):
        raise ValueError(f"{splits} splits of {B * N} (row, head) pairs and {NW} windows")

    ctx = torch.empty_like(q)
    part = counters = None
    if splits > 1:
        part = torch.empty((splits, B, N, D + 2), dtype=torch.float32, device=q.device)
        counters = _counters(q.device)
    launch("decode_attention", fn, q.device,
           q.data_ptr(), int(q.dtype == torch.bfloat16), ring_l.data_ptr(),
           kv_l.data_ptr(), scales_l.data_ptr(), ctx.data_ptr(),
           None if part is None else part.data_ptr(),
           None if counters is None else counters.data_ptr(),
           B, N, D, NW, int(index), splits)
    if packed:
        decode_attention_quant.launches_int4 += 1
    else:
        decode_attention_quant.launches += 1
    return ctx


# launches of K1 (int8 cache) and of K2 (int4 cache)
decode_attention_quant.launches = 0
decode_attention_quant.launches_int4 = 0
