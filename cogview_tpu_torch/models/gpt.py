"""CogView GPT with Sandwich-LayerNorm (twin of cogview_tpu/models/gpt.py).

Parameters are a plain dictionary with the JAX package's tree and names:
per-layer leaves are stacked ``[L, ...]`` (``qkv.w`` is ``[L, H, 3, H]``) and
int8 weight-only leaves swap ``{"w"}`` for ``{"w8", "s"}``.  The layer loop
is a Python loop over ``p[li]`` views, in place of ``lax.scan``.

Per layer (Sandwich-LN):
  h = h + LN3(Wo @ attn(LN1(h)))
  h = h + LN4(W2 @ gelu(W1 @ LN2(h)))
with a final LayerNorm and float32 logits tied to the word embedding.

Only the inference slice is ported: no dropout, no training paths, no
sparse or flash attention, and only the int8 KV cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import GPTConfig
from ..ops.attention import causal_mask, decode_mask, dense_attention, dense_attention_kvT
from ..ops.decode_attention import (
    SEAL_GROUP, WRITE_WINDOW, decode_attention_quant, dequantize_kv, gather_kv,
    gather_kv_scales, pad_cache_len, quantize_kv, scatter_kv_columns,
    scatter_kv_scales)
from ..ops.layernorm import layer_norm

Params = Dict[str, Any]


# --------------------------------------------------------------------- #
# init and weight quantization
# --------------------------------------------------------------------- #


def init_params(cfg: GPTConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random initial weights, made directly in ``dtype`` on ``device``: a
    float32 draw and then a cast would double peak memory at 4B params.
    ``generator`` must live on ``device``."""
    H, L, V, P = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.max_position_embeddings)
    std = cfg.init_std
    out_std = std / math.sqrt(2.0 * L) if cfg.scaled_output_init else std
    kw = dict(dtype=dtype, device=device)

    def nrm(shape, s):
        return torch.randn(shape, generator=generator, **kw).mul_(s)

    def ln(shape=(L, H)):
        return {"g": torch.ones(shape, **kw), "b": torch.zeros(shape, **kw)}

    return {
        "embed": {"word": nrm((V, H), std), "pos": nrm((P, H), std)},
        "layers": {
            "ln_in": ln(),
            "qkv": {"w": nrm((L, H, 3, H), std), "b": torch.zeros((L, 3, H), **kw)},
            "attn_out": {"w": nrm((L, H, H), out_std), "b": torch.zeros((L, H), **kw)},
            "ln_attn": ln(),
            "ln_post": ln(),
            "mlp_in": {"w": nrm((L, H, 4 * H), std), "b": torch.zeros((L, 4 * H), **kw)},
            "mlp_out": {"w": nrm((L, 4 * H, H), out_std), "b": torch.zeros((L, H), **kw)},
            "ln_mlp": ln(),
        },
        "ln_final": {"g": torch.ones((H,), **kw), "b": torch.zeros((H,), **kw)},
    }


def _quantize(w: torch.Tensor, caxis: int) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over ``caxis`` with one float32 scale per output
    channel: s = max(absmax, 1e-12) / 127, w8 = round(w / s)."""
    w = w.float()
    amax = torch.clamp(w.abs().amax(dim=caxis, keepdim=True), min=1e-12)
    s = amax / amax.new_full((), 127.0)  # IEEE division on CUDA too
    return {"w8": torch.round(w / s).to(torch.int8), "s": s.squeeze(caxis)}


def _quantize_stacked(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-layer :func:`_quantize` of a stacked [L, in, ...] weight over its
    input axis; one layer at a time keeps the float32 transient small."""
    parts = [_quantize(w[li], 0) for li in range(w.shape[0])]
    return {"w8": torch.stack([p["w8"] for p in parts]),
            "s": torch.stack([p["s"] for p in parts])}


def quantize_weights(params: Params) -> Params:
    """Weight-only per-output-channel int8 of qkv / attn_out / mlp_in /
    mlp_out and the tied word embedding.  Biases, LayerNorms and the
    position table keep their dtype."""
    lyr = params["layers"]

    def mat(name):
        return {**_quantize_stacked(lyr[name]["w"]), "b": lyr[name]["b"]}

    return {
        "embed": {
            # word [V, H]: logits contract over H -> one scale per vocab row
            "word": _quantize(params["embed"]["word"], 1),
            "pos": params["embed"]["pos"],
        },
        "layers": {
            "ln_in": lyr["ln_in"],
            "qkv": mat("qkv"),
            "attn_out": mat("attn_out"),
            "ln_attn": lyr["ln_attn"],
            "ln_post": lyr["ln_post"],
            "mlp_in": mat("mlp_in"),
            "mlp_out": mat("mlp_out"),
            "ln_mlp": lyr["ln_mlp"],
        },
        "ln_final": params["ln_final"],
    }


def _wmul(x: torch.Tensor, leaf: Params, cdt: torch.dtype, out32: bool = True,
          transpose: bool = False) -> torch.Tensor:
    """x [..., in] times a weight leaf, ``{"w"}`` or ``{"w8", "s"}``, whose
    input axis is the first (or, with ``transpose``, the last) -> [..., out].

    Returns float32, bias not yet added.  ``out32=False`` with bfloat16
    compute returns the product rounded to bfloat16 before the caller's
    float32 bias add, as the JAX package does for the layer matmuls.  An
    int8 leaf always returns float32: (x @ w8) * s.

    The JAX package asks the dot itself for a float32 result; PyTorch's
    bfloat16 matmul accumulates in float32 but returns bfloat16, so with
    bfloat16 compute the int8 path and the logits carry one bfloat16
    rounding the JAX package does not.  float32 compute is identical."""
    if "w8" in leaf:
        w = leaf["w8"]
        w = w.t() if transpose else w.reshape(w.shape[0], -1)
        y = torch.matmul(x, w.to(cdt)).float()
        return y * leaf["s"].reshape(-1)
    w = leaf["w"]
    w = w.t() if transpose else w.reshape(w.shape[0], -1)
    y = torch.matmul(x, w.to(cdt))
    want32 = out32 or x.dtype != torch.bfloat16
    return y.float() if want32 else y


def _affine(x, leaf, cdt):
    """(x @ W + b) in compute dtype, the layer matmul of the JAX package."""
    return (_wmul(x, leaf, cdt, out32=False) + leaf["b"].float().reshape(-1)).to(cdt)


# --------------------------------------------------------------------- #
# KV cache
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache + per-(head, token) scales + the exact ring.

    Layout is the JAX package's (ops/decode_attention.py): data
    [L, NW, B, 2, N, D, W] int8, scales [L, NW, B, 2, N, W] float32, ring
    [L, G, B, N, 2*D] float32.  The tensors are updated in place.

    Sequencing contract: every Q>1 prefill chunk must precede the first
    Q==1 decode step.  After decode steps that do not end a seal group, the
    newest positions exist only in the ring; a later Q>1 chunk would attend
    unsealed cache slots and could evict ring columns before they seal.
    ``decoding`` records that a decode step ran, and a later prefill
    raises."""

    kv: torch.Tensor
    scale: torch.Tensor
    recent: torch.Tensor
    decoding: bool = False

    @property
    def max_len(self) -> int:
        return self.kv.shape[1] * self.kv.shape[6]


def init_cache(cfg: GPTConfig, batch: int, max_len: int, device=None) -> QuantKVCache:
    """Zero int8 data, scales of ONE (as the JAX package), zero ring."""
    L, N, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
    NW = pad_cache_len(max_len) // WRITE_WINDOW
    return QuantKVCache(
        torch.zeros((L, NW, batch, 2, N, D, WRITE_WINDOW), dtype=torch.int8, device=device),
        torch.ones((L, NW, batch, 2, N, WRITE_WINDOW), dtype=torch.float32, device=device),
        torch.zeros((L, SEAL_GROUP, batch, N, 2 * D), dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------- #
# core
# --------------------------------------------------------------------- #


def _layer(params: Params, li: int) -> Params:
    """Layer ``li``'s leaves (views into the stacked [L, ...] tensors)."""
    return {k: {kk: vv[li] for kk, vv in v.items()}
            for k, v in params["layers"].items()}


def _layer_body(cfg: GPTConfig, h: torch.Tensor, p: Params, mask: torch.Tensor,
                cache: Optional[QuantKVCache] = None, li: int = 0, index: int = 0,
                full_prefix: bool = False) -> torch.Tensor:
    """One transformer layer.  Without ``cache``: dense attention under
    ``mask``.  With the int8 cache: S == 1 is a decode step through the
    decode kernel; S > 1 is a prefill chunk at slots [index, index + S)."""
    B, S, H = h.shape
    N, D = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_epsilon
    cdt = h.dtype

    ln1 = layer_norm(h, p["ln_in"]["g"], p["ln_in"]["b"], eps, cfg.pb_relax)
    qkv = _affine(ln1, p["qkv"], cdt).reshape(B, S, 3, H)
    q = qkv[:, :, 0].reshape(B, S, N, D)
    k = qkv[:, :, 1]
    v = qkv[:, :, 2]

    if cache is None:
        ctx = dense_attention(q, k.reshape(B, S, N, D), v.reshape(B, S, N, D), mask)
    else:
        kv_l, s_l, ring_l = cache.kv[li], cache.scale[li], cache.recent[li]
        G = ring_l.shape[0]
        if S == 1:
            # append the current token's exact K|V column to ring slot
            # index % G, then attend sealed int8 windows + the ring; the
            # kernel seals a whole group every G-th step
            cols = torch.cat([k[:, 0].reshape(B, N, D), v[:, 0].reshape(B, N, D)], dim=-1)
            ring_l[index % G].copy_(cols)
            ctx = decode_attention_quant(q[:, 0].contiguous(), ring_l, kv_l, s_l, index)
            ctx = ctx.to(cdt)
        else:
            k8, ksc = quantize_kv(k.transpose(1, 2), N)
            v8, vsc = quantize_kv(v.transpose(1, 2), N)
            scatter_kv_columns(kv_l, k8, v8, index)
            scatter_kv_scales(s_l, ksc, vsc, index)
            # fill the ring with the last min(G, S) columns: G consecutive
            # positions cover every residue, so each slot g <= p % G holds
            # the newest position with that residue
            gl = min(G, S)
            tail = torch.cat([k[:, S - gl:].reshape(B, gl, N, D),
                              v[:, S - gl:].reshape(B, gl, N, D)], dim=-1)
            pstart = index + S - gl
            for i in range(gl):
                ring_l[(pstart + i) % G].copy_(tail[:, i])
            if full_prefix:
                # the chunk is the whole visible prefix: attend the
                # just-quantized local columns
                kT, vT = dequantize_kv(k8, ksc, cdt), dequantize_kv(v8, vsc, cdt)
                ctx = dense_attention_kvT(q, kT, vT, mask[..., :S])
            else:
                k8g, v8g = gather_kv(kv_l)
                ksg, vsg = gather_kv_scales(s_l)
                kT, vT = dequantize_kv(k8g, ksg, cdt), dequantize_kv(v8g, vsg, cdt)
                ctx = dense_attention_kvT(q, kT, vT, mask)
    ctx = ctx.reshape(B, S, H)

    attn_out = _affine(ctx, p["attn_out"], cdt)
    if cfg.sandwich_ln:
        attn_out = layer_norm(attn_out, p["ln_attn"]["g"], p["ln_attn"]["b"], eps, cfg.pb_relax)
    h = h + attn_out

    ln2 = layer_norm(h, p["ln_post"]["g"], p["ln_post"]["b"], eps, cfg.pb_relax)
    inter = F.gelu(_affine(ln2, p["mlp_in"], cdt), approximate="tanh")
    mlp_out = _affine(inter, p["mlp_out"], cdt)
    if cfg.sandwich_ln:
        mlp_out = layer_norm(mlp_out, p["ln_mlp"]["g"], p["ln_mlp"]["b"], eps, cfg.pb_relax)
    return h + mlp_out


def _embed(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
           position_ids: torch.Tensor) -> torch.Tensor:
    cdt = cfg.compute_dtype
    word = params["embed"]["word"]
    if isinstance(word, dict):
        rows = word["w8"][tokens].float()
        h = (rows * word["s"][tokens][..., None]).to(cdt)
    else:
        h = word[tokens].to(cdt)
    return h + params["embed"]["pos"][position_ids].to(cdt)


def _logits(params: Params, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    """Tied output projection, float32 logits."""
    word = params["embed"]["word"]
    leaf = word if isinstance(word, dict) else {"w": word}
    return _wmul(h, leaf, h.dtype, transpose=True)


def _final(params: Params, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    lnf = params["ln_final"]
    h = layer_norm(h, lnf["g"], lnf["b"], cfg.layernorm_epsilon, cfg.pb_relax)
    return _logits(params, cfg, h)


def forward(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
            position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal forward -> float32 logits [B, S, V]."""
    B, S = tokens.shape
    if position_ids is None:
        position_ids = torch.arange(S, device=tokens.device).expand(B, S)
    mask = causal_mask(S, device=tokens.device)
    h = _embed(params, cfg, tokens, position_ids)
    for li in range(cfg.num_layers):
        h = _layer_body(cfg, h, _layer(params, li), mask)
    return _final(params, cfg, h)


@torch.no_grad()
def forward_with_cache(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                       position_ids: torch.Tensor, cache: QuantKVCache,
                       index: int) -> torch.Tensor:
    """Prefill (Q = context length) or decode (Q = 1) at absolute slot
    ``index`` -> float32 logits [B, Q, V]; ``cache`` is updated in place.

    Attention visibility uses absolute slots (index + arange(Q)); the
    position ids only select position embeddings.  A Q > 1 chunk at index 0
    is the whole visible prefix and attends its own quantized columns.  See
    :class:`QuantKVCache` for the sequencing contract."""
    B, Q = tokens.shape
    index = int(index)
    if Q > 1 and cache.decoding:
        raise ValueError(
            "forward_with_cache: Q>1 chunk after a decode step on a quantized "
            "cache; prefill chunks must precede all decode steps")
    if Q == 1:
        cache.decoding = True
    h = _embed(params, cfg, tokens, position_ids)
    q_abs = index + torch.arange(Q, device=tokens.device)
    mask = decode_mask(q_abs.expand(B, Q), cache.max_len)
    full_prefix = Q > 1 and index == 0
    for li in range(cfg.num_layers):
        h = _layer_body(cfg, h, _layer(params, li), mask, cache, li, index,
                        full_prefix)
    return _final(params, cfg, h)
