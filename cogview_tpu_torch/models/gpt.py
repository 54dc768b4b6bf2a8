"""CogView GPT with Sandwich-LayerNorm (twin of cogview_tpu/models/gpt.py).

Parameters are a plain dictionary with the JAX package's tree and names:
per-layer leaves are stacked ``[L, ...]`` (``qkv.w`` is ``[L, H, 3, H]``) and
int8 weight-only leaves swap ``{"w"}`` for ``{"w8", "s"}``.  The layer loop
is a Python loop over ``p[li]`` views, in place of ``lax.scan``.

Per layer (Sandwich-LN):
  h = h + LN3(Wo @ attn(LN1(h)))
  h = h + LN4(W2 @ gelu(W1 @ LN2(h)))
with a final LayerNorm and float32 logits tied to the word embedding.

Ported: the inference paths with the int8, int4 and bfloat16 KV caches,
and the training forwards (``forward(train=True, seeds=..., remat=...)``,
with pivot + window sparse attention through ``sparse=``, and
``forward_with_mems``, transformer-XL memory) with counter-hash dropout at
the JAX package's salted sites.  A full causal forward at S >=
``flash_min_seq`` runs its attention through the flash kernels
(ops/flash_attention.py), forward and backward, as the JAX package routes
it; the sparse and memory routes are plain torch, as they are plain XLA
there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import GPTConfig
from ..ops.attention import causal_mask, decode_mask, dense_attention, dense_attention_kvT
from ..ops.decode_attention import (
    SEAL_GROUP, WRITE_WINDOW, decode_attention_quant, gather_kv, gather_kv_scales, kv_codec,
    pad_cache_len, scatter_kv_columns, scatter_kv_scales)
from ..ops.flash_attention import flash_attention
from ..ops.hash_prng import hash_dropout
from ..ops.layernorm import layer_norm
from ..ops.sparse_attention import pivot_window_attention

Params = Dict[str, Any]


class SparseSpec(NamedTuple):
    """Pivot + window sparse attention inputs (ops/sparse_attention.py)."""

    pivot_idx: torch.Tensor  # [B, P]
    pivot_mask: torch.Tensor  # [B, S, P]
    query_window: int
    key_window_times: int


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


def extend_position_embedding(weight: torch.Tensor, length: int) -> torch.Tensor:
    """A position table [P, H] fitted to [length, H]: truncated when length
    <= P, else tiled and the tiling truncated to length (rows P.. reuse rows
    0..; the reference's ``expand(length // P)`` where P divides length)."""
    P = weight.shape[0]
    if length <= P:
        return weight[:length]
    return weight.repeat(-(-length // P), 1)[:length]


def adapt_position_embeddings(params: Params, cfg: GPTConfig) -> Params:
    """Fit loaded params to ``cfg.max_position_embeddings``: a 1089-position
    base checkpoint into the 1345-position super-resolution preset, or a
    longer table truncated.  The same params when the lengths match."""
    pos = params["embed"]["pos"]
    target = cfg.max_position_embeddings
    if pos.shape[0] == target:
        return params
    return {**params, "embed": {**params["embed"],
                                "pos": extend_position_embedding(pos, target)}}


class _MatmulF32(torch.autograd.Function):
    """[M, K] @ [K, N] of low-precision CUDA operands -> float32, float32
    sums and no rounding of the output.  The backward multiplies in the
    operands' dtype with float32 sums, as autograd of a low-precision matmul
    does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.mm(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = torch.mm(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> float32 [..., N] with float32 sums and no
    rounding to x's dtype: the JAX package's ``preferred_element_type=
    float32``.  On the CPU the operands are upcast: a product of two bf16
    or fp16 values is exact in float32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type != "cuda":
        return torch.matmul(x.float(), w.float())
    y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _wmul(x: torch.Tensor, leaf: Params, cdt: torch.dtype, out32: bool = True,
          transpose: bool = False) -> torch.Tensor:
    """x [..., in] times a weight leaf, ``{"w"}`` or ``{"w8", "s"}``, whose
    input axis is the first (or, with ``transpose``, the last) -> [..., out].

    Returns float32, bias not yet added: the product of the compute-dtype
    operands with float32 sums, not rounded to the compute dtype (the JAX
    package's ``preferred_element_type=float32``).  ``out32=False`` with
    bfloat16 compute instead returns the product rounded to bfloat16 before
    the caller's float32 bias add, as the JAX package does for the layer
    matmuls.  An int8 leaf always returns float32: (x @ w8) * s."""
    if "w8" in leaf:
        w = leaf["w8"]
        w = w.t() if transpose else w.reshape(w.shape[0], -1)
        return _matmul_f32(x, w.to(cdt)) * leaf["s"].reshape(-1)
    w = leaf["w"]
    w = w.t() if transpose else w.reshape(w.shape[0], -1)
    if out32 or x.dtype != torch.bfloat16:
        return _matmul_f32(x, w.to(cdt))
    return torch.matmul(x, w.to(cdt))


def _affine(x, leaf, cdt):
    """(x @ W + b) in compute dtype, the layer matmul of the JAX package."""
    return (_wmul(x, leaf, cdt, out32=False) + leaf["b"].float().reshape(-1)).to(cdt)


# --------------------------------------------------------------------- #
# KV cache
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class KVCache:
    """The exact cache (``kv_cache_dtype="bfloat16"``): K and V stored
    transposed, [L, B, H, T] with T = max_len (unpadded), in the compute
    dtype.  Attention runs dense over all T slots under the decode mask.
    It has no sequencing contract: chunks and decode steps mix freely."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


@dataclasses.dataclass
class QuantKVCache:
    """int8 or packed int4 KV cache + per-(head, token) scales + the exact
    ring.

    Layout is the JAX package's (ops/decode_attention.py): data
    [L, NW, B, 2, N, Dc, W] int8 with Dc = D (int8) or D/2 (int4), scales
    [L, NW, B, 2, N, W] float32, ring [L, G, B, N, 2*D] float32.  The
    tensors are updated in place.

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


def init_cache(cfg: GPTConfig, batch: int, max_len: int, device=None):
    """The cache ``cfg.kv_cache_dtype`` names, as the JAX package makes it:
    int8 or int4 (Dc = D/2) data of zeros, scales of ONE and a zero float32
    ring; or zero [L, B, H, max_len] K and V in the compute dtype."""
    L, H, N, D = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim
    if cfg.kv_cache_dtype == "bfloat16":
        shape = (L, batch, H, max_len)
        return KVCache(torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                       torch.zeros(shape, dtype=cfg.compute_dtype, device=device))
    NW = pad_cache_len(max_len) // WRITE_WINDOW
    Dc = D if cfg.kv_cache_dtype == "int8" else D // 2
    return QuantKVCache(
        torch.zeros((L, NW, batch, 2, N, Dc, WRITE_WINDOW), dtype=torch.int8, device=device),
        torch.ones((L, NW, batch, 2, N, WRITE_WINDOW), dtype=torch.float32, device=device),
        torch.zeros((L, SEAL_GROUP, batch, N, 2 * D), dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------- #
# core
# --------------------------------------------------------------------- #


def _layers(params: Params) -> List[Params]:
    """Every layer's leaves, views of the stacked [L, ...] tensors made by
    one ``unbind`` per leaf.  Its backward stacks the L layer gradients once;
    a ``select`` per layer would instead add a zero-filled tensor the size of
    the whole stacked leaf into the gradient for each layer."""
    per = {k: {kk: torch.unbind(vv) for kk, vv in v.items()}
           for k, v in params["layers"].items()}
    return [{k: {kk: vv[li] for kk, vv in v.items()} for k, v in per.items()}
            for li in range(len(per["ln_in"]["g"]))]


def should_use_flash(cfg: GPTConfig, seq_len: int) -> bool:
    """Flash-attention eligibility of a full causal forward.  float16
    compute stays on dense attention even when flash is forced, as in the
    JAX package; the flash kernels take bfloat16 and float32 only."""
    if cfg.compute_dtype == torch.float16:
        return False
    return (cfg.use_flash_attention is True
            or (cfg.use_flash_attention == "auto" and seq_len >= cfg.flash_min_seq))


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int], train: bool,
             salt: int) -> torch.Tensor:
    """Counter-hash dropout (ops/hash_prng.py) in training, else ``x``."""
    if not train or rate <= 0.0 or seed is None:
        return x
    return hash_dropout(x, rate, seed, salt)


def _layer_body(cfg: GPTConfig, h: torch.Tensor, p: Params, mask: torch.Tensor,
                cache=None, li: int = 0, index: int = 0,
                full_prefix: bool = False, sep_for_flash: Optional[int] = None,
                seed: Optional[int] = None, train: bool = False,
                sparse: Optional[SparseSpec] = None,
                mem: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer layer.  Without ``cache``: pivot + window attention
    when ``sparse`` is given, else the flash kernels when ``mask`` is
    exactly causal + ``sep_for_flash`` and :func:`should_use_flash` says so,
    else dense attention under ``mask``.  ``mem`` [B, M, H] is this layer's
    transformer-XL memory: it goes through this layer's input LayerNorm and
    QKV projection and adds M keys and values in front (no queries).
    With a quantized cache (int8 or int4): S == 1 is a decode step through a
    decode kernel; S > 1 is a prefill chunk at slots [index, index + S).
    With the bfloat16 cache: the chunk's K/V columns are written at
    ``index`` and attention runs dense over the whole cache under ``mask``.

    In training, ``seed`` is the layer's uint32 seed: salt 1 drops attention
    probabilities on the dense route (the flash kernels are seeded with
    ``seed ^ 0x5BD1E995``), salt 2 the attention output, salt 3 the MLP
    output."""
    B, S, H = h.shape
    N, D = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_epsilon
    cdt = h.dtype
    lseed = seed if train else None

    ln1 = layer_norm(h, p["ln_in"]["g"], p["ln_in"]["b"], eps, cfg.pb_relax)
    qkv = _affine(ln1, p["qkv"], cdt).reshape(B, S, 3, H)
    q = qkv[:, :, 0].reshape(B, S, N, D)
    k = qkv[:, :, 1]
    v = qkv[:, :, 2]
    if mem is not None:
        lnm = layer_norm(mem.to(cdt), p["ln_in"]["g"], p["ln_in"]["b"], eps, cfg.pb_relax)
        qkv_m = _affine(lnm, p["qkv"], cdt).reshape(B, mem.shape[1], 3, H)
        k = torch.cat([qkv_m[:, :, 1], k], dim=1)
        v = torch.cat([qkv_m[:, :, 2], v], dim=1)

    if cache is None and sparse is not None:
        ctx = pivot_window_attention(
            q, k.reshape(B, S, N, D), v.reshape(B, S, N, D), sparse.pivot_idx,
            sparse.pivot_mask, sparse.query_window, sparse.key_window_times,
            dropout_rate=cfg.attention_dropout, dropout_seed=lseed, train=train)
    elif cache is None and sep_for_flash is not None and should_use_flash(cfg, S):
        # strided q/k/v views of the fused projection go in as they are
        rate = cfg.attention_dropout if lseed is not None else 0.0
        fseed = (lseed ^ 0x5BD1E995) if rate > 0.0 else None
        ctx, _ = flash_attention(q, k.reshape(B, S, N, D), v.reshape(B, S, N, D),
                                 sep_for_flash, dropout_rate=rate, dropout_seed=fseed)
    elif cache is None:
        ctx = dense_attention(q, k.reshape(B, -1, N, D), v.reshape(B, -1, N, D), mask,
                              dropout_rate=cfg.attention_dropout, dropout_seed=lseed,
                              train=train)
    elif isinstance(cache, KVCache):
        ck, cv = cache.k[li], cache.v[li]  # [B, H, T] views
        ck[:, :, index:index + S] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, index:index + S] = v.transpose(1, 2).to(cv.dtype)
        T = ck.shape[2]
        ctx = dense_attention_kvT(q, ck.to(cdt).reshape(B, N, D, T),
                                  cv.to(cdt).reshape(B, N, D, T), mask)
    else:
        kv_l, s_l, ring_l = cache.kv[li], cache.scale[li], cache.recent[li]
        G = ring_l.shape[0]
        if S == 1:
            # append the current token's exact K|V column to ring slot
            # index % G, then attend sealed windows + the ring; the kernel
            # seals a whole group every G-th step
            cols = torch.cat([k[:, 0].reshape(B, N, D), v[:, 0].reshape(B, N, D)], dim=-1)
            ring_l[index % G].copy_(cols)
            ctx = decode_attention_quant(q[:, 0].contiguous(), ring_l, kv_l, s_l, index)
            ctx = ctx.to(cdt)
        else:
            quant, dequant = kv_codec(kv_l, D)
            k8, ksc = quant(k.transpose(1, 2), N)
            v8, vsc = quant(v.transpose(1, 2), N)
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
                kT, vT = dequant(k8, ksc, cdt), dequant(v8, vsc, cdt)
                ctx = dense_attention_kvT(q, kT, vT, mask[..., :S])
            else:
                k8g, v8g = gather_kv(kv_l)
                ksg, vsg = gather_kv_scales(s_l)
                kT, vT = dequant(k8g, ksg, cdt), dequant(v8g, vsg, cdt)
                ctx = dense_attention_kvT(q, kT, vT, mask)
    ctx = ctx.reshape(B, S, H)

    attn_out = _affine(ctx, p["attn_out"], cdt)
    attn_out = _dropout(attn_out, cfg.output_dropout, lseed, train, salt=2)
    if cfg.sandwich_ln:
        attn_out = layer_norm(attn_out, p["ln_attn"]["g"], p["ln_attn"]["b"], eps, cfg.pb_relax)
    h = h + attn_out

    ln2 = layer_norm(h, p["ln_post"]["g"], p["ln_post"]["b"], eps, cfg.pb_relax)
    inter = F.gelu(_affine(ln2, p["mlp_in"], cdt), approximate="tanh")
    mlp_out = _affine(inter, p["mlp_out"], cdt)
    mlp_out = _dropout(mlp_out, cfg.output_dropout, lseed, train, salt=3)
    if cfg.sandwich_ln:
        mlp_out = layer_norm(mlp_out, p["ln_mlp"]["g"], p["ln_mlp"]["b"], eps, cfg.pb_relax)
    return h + mlp_out


def _embed(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
           position_ids: torch.Tensor, seed: Optional[int] = None,
           train: bool = False) -> torch.Tensor:
    cdt = cfg.compute_dtype
    word = params["embed"]["word"]
    if isinstance(word, dict):
        rows = word["w8"][tokens].float()
        h = (rows * word["s"][tokens][..., None]).to(cdt)
    else:
        h = word[tokens].to(cdt)
    h = h + params["embed"]["pos"][position_ids].to(cdt)
    return _dropout(h, cfg.embedding_dropout, seed, train, salt=4)


def _logits(params: Params, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    """Tied output projection, float32 logits."""
    word = params["embed"]["word"]
    leaf = word if isinstance(word, dict) else {"w": word}
    return _wmul(h, leaf, h.dtype, transpose=True)


def _final_ln(params: Params, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    lnf = params["ln_final"]
    return layer_norm(h, lnf["g"], lnf["b"], cfg.layernorm_epsilon, cfg.pb_relax)


def _check_seeds(cfg: GPTConfig, seeds: Optional[Sequence[int]]) -> Sequence[Optional[int]]:
    L = cfg.num_layers
    if seeds is None:
        return [None] * (L + 1)
    if len(seeds) != L + 1:
        raise ValueError(f"seeds: {len(seeds)} values, expected num_layers + 1 = {L + 1}")
    return seeds


def _run_layer(cfg: GPTConfig, h: torch.Tensor, p: Params, mask: torch.Tensor,
               remat: bool, **kw) -> torch.Tensor:
    """One layer, recomputed in the backward when ``remat``."""
    if remat:
        return checkpoint(_layer_body, cfg, h, p, mask, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return _layer_body(cfg, h, p, mask, **kw)


def forward(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
            position_ids: Optional[torch.Tensor] = None, *, sep: int = 0,
            train: bool = False, seeds: Optional[Sequence[int]] = None,
            remat: bool = False, sparse: Optional[SparseSpec] = None,
            logits_from: Optional[int] = None,
            return_hidden: bool = False) -> torch.Tensor:
    """Full forward under the causal mask with a bidirectional prefix of
    ``sep`` positions -> float32 logits [B, S, V].

    ``train=True`` with ``seeds`` applies dropout: ``seeds`` holds L + 1
    uint32 values, the embedding's first, then one per layer (the JAX
    package derives them from its key; the port takes them as given).
    ``remat=True`` recomputes each layer in the backward
    (``torch.utils.checkpoint``), so the flash forward runs twice per layer.
    ``sparse`` switches every layer to pivot + window attention (one pivot
    set for all layers); ``sep`` is then ignored.

    ``logits_from=t`` keeps positions >= t only ([B, S - t, V]); the final
    LayerNorm then sees only those positions, whose PB-relax max is over
    them alone, as in the JAX package.  ``return_hidden=True`` returns the
    final-LayerNorm hidden states in place of logits."""
    B, S = tokens.shape
    if position_ids is None:
        position_ids = torch.arange(S, device=tokens.device).expand(B, S)
    seeds = _check_seeds(cfg, seeds)
    mask = causal_mask(S, sep=sep, device=tokens.device)
    h = _embed(params, cfg, tokens, position_ids, seeds[0], train)
    for li, p in enumerate(_layers(params)):
        h = _run_layer(cfg, h, p, mask, remat, sep_for_flash=sep, seed=seeds[li + 1],
                       train=train, sparse=sparse)
    if logits_from is not None:
        h = h[:, logits_from:]
    h = _final_ln(params, cfg, h)
    return h if return_hidden else _logits(params, cfg, h)


def update_mems(hiddens: torch.Tensor, mems: Optional[torch.Tensor],
                max_memory_length: int) -> torch.Tensor:
    """The rolling, detached memory: hiddens [L + 1, B, S, H] (the embedding
    output and every layer's output) after the last mems [L + 1, B, M, H]
    -> their last min(max_memory_length, M + S) positions."""
    S = hiddens.shape[2]
    M = 0 if mems is None else mems.shape[2]
    new_len = min(max_memory_length, M + S)
    if new_len <= S:
        out = hiddens[:, :, S - new_len:]
    else:
        out = torch.cat([mems[:, :, M - (new_len - S):], hiddens], dim=2)
    return out.detach()


def forward_with_mems(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                      mems: Optional[torch.Tensor] = None, *, max_memory_length: int,
                      position_ids: Optional[torch.Tensor] = None, sep: int = 0,
                      train: bool = False, seeds: Optional[Sequence[int]] = None,
                      remat: bool = False, return_hidden: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-time transformer-XL memory -> (float32 logits [B, S, V], or
    the final-LayerNorm hidden states with ``return_hidden``, and the new
    mems [L + 1, B, M', H]).

    Every memory position is visible to every query; keys and values run
    over LN(mem) ++ LN(h) through dense attention (``causal_mask(S, sk=M +
    S, sep)``).  Entry i of ``mems`` feeds layer i; entry 0 is the
    embedding output, and entry L, the last layer's output, is returned and
    never read, as in the reference."""
    B, S = tokens.shape
    if position_ids is None:
        position_ids = torch.arange(S, device=tokens.device).expand(B, S)
    seeds = _check_seeds(cfg, seeds)
    M = 0 if mems is None else mems.shape[2]
    mask = causal_mask(S, sk=M + S, sep=sep, device=tokens.device)
    h = _embed(params, cfg, tokens, position_ids, seeds[0], train)
    outs = [h]
    for li, p in enumerate(_layers(params)):
        h = _run_layer(cfg, h, p, mask, remat, seed=seeds[li + 1], train=train,
                       mem=None if mems is None else mems[li])
        outs.append(h)
    new_mems = update_mems(torch.stack(outs).detach(), mems, max_memory_length)
    h = _final_ln(params, cfg, h)
    return (h if return_hidden else _logits(params, cfg, h)), new_mems


@torch.no_grad()
def forward_with_cache(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                       position_ids: torch.Tensor, cache, index: int) -> torch.Tensor:
    """Prefill (Q = context length) or decode (Q = 1) at absolute slot
    ``index`` -> float32 logits [B, Q, V]; ``cache`` is updated in place.

    Attention visibility uses absolute slots (index + arange(Q)); the
    position ids only select position embeddings.  ``cache`` is a
    :class:`QuantKVCache` (int8 or int4) or a :class:`KVCache` (bfloat16).
    On a quantized cache a Q > 1 chunk at index 0 is the whole visible
    prefix and attends its own quantized columns; see :class:`QuantKVCache`
    for its sequencing contract."""
    B, Q = tokens.shape
    index = int(index)
    if isinstance(cache, QuantKVCache):
        if Q > 1 and cache.decoding:
            raise ValueError(
                "forward_with_cache: Q>1 chunk after a decode step on a quantized "
                "cache; prefill chunks must precede all decode steps")
        if Q == 1:
            cache.decoding = True
    h = _embed(params, cfg, tokens, position_ids)
    q_abs = index + torch.arange(Q, device=tokens.device)
    mask = decode_mask(q_abs.expand(B, Q), cache.max_len)
    full_prefix = Q > 1 and index == 0 and isinstance(cache, QuantKVCache)
    for li, p in enumerate(_layers(params)):
        h = _layer_body(cfg, h, p, mask, cache, li, index, full_prefix)
    return _logits(params, cfg, _final_ln(params, cfg, h))
