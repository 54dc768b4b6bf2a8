"""Checkpoint converters: the reference's released ``.pt`` layouts -> the
port's parameter trees (twin of cogview_tpu/models/convert.py).

Two artifact families:

* the VQ-VAE (``vqvae_hard_biggerset_011.pt``): a bare state dict, possibly
  ``module.``-prefixed or under ``state_dict``;
* the CogView GPT's DeepSpeed checkpoints (``mp_rank_00_model_states.pt``,
  ``{"module": state_dict}``), or a plain ``{"model": ...}`` or bare state
  dict, with or without the ``module.`` prefix.

The port's GPT tree is the JAX package's (stacked ``[L, ...]`` leaves,
``qkv.w`` ``[L, H, 3, H]``, matrices ``[in, out]``), so the GPT converter
builds it directly as tensors on the target device.  The port's VQ-VAE
keeps PyTorch's conv layouts (OIHW, and ``[in, out, kh, kw]`` for the
transposed convs), so its converter only renames keys; the codebook's EMA
statistics (training state) are dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

Params = Dict[str, Any]


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    if sd and next(iter(sd)).startswith("module."):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


# --------------------------------------------------------------------- #
# VQ-VAE
# --------------------------------------------------------------------- #


def vqvae_from_state_dict(sd: Mapping[str, Any], device=None) -> Params:
    """The reference VQ-VAE's state dict -> the port's VQ-VAE params, float32
    (the JAX converter's dtype) on ``device``."""
    sd = strip_module_prefix(sd)

    def f32(key):
        return torch.as_tensor(sd[key]).to(device=device, dtype=torch.float32)

    def conv(prefix):
        return {"w": f32(f"{prefix}.weight"), "b": f32(f"{prefix}.bias")}

    return {
        "encoder": {
            "conv0": conv("enc_b.blocks.0"),
            "conv1": conv("enc_b.blocks.2"),
            "conv2": conv("enc_b.blocks.4"),
            "proj": conv("enc_b.blocks.6"),
        },
        "quantize": {"embed": f32("quantize_t.embed")},
        "decoder": {
            "convt0": conv("dec.blocks.0"),
            "convt1": conv("dec.blocks.2"),
            "convt2": conv("dec.blocks.4"),
            "proj": conv("dec.blocks.6"),
        },
    }


def load_vqvae_checkpoint(path: str, device=None) -> Params:
    """A VQ-VAE ``.pt`` file (tensors only: ``weights_only=True``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return vqvae_from_state_dict(ckpt, device)


# --------------------------------------------------------------------- #
# GPT (the CogView transformer)
# --------------------------------------------------------------------- #


def gpt_from_state_dict(sd: Mapping[str, Any], num_layers: int, num_heads: int,
                        dtype: Optional[torch.dtype] = None, consume: bool = False,
                        device=None) -> Params:
    """A Megatron-style GPT2Model state dict -> the port's GPT params on
    ``device``, one tensor at a time in the STORED dtype (``dtype`` forces
    another).

    Source layout (model/gpt2_modeling.py + mpu/sparse_transformer.py):
      word_embeddings.weight                     [V, H]
      transformer.position_embeddings.weight     [P, H]
      transformer.layers.{i}.input_layernorm.{weight,bias}
      transformer.layers.{i}.attention.query_key_value.{weight,bias} [3H, H]
      transformer.layers.{i}.attention.dense.{weight,bias}           [H, H]
      transformer.layers.{i}.post_attention_layernorm.*
      transformer.layers.{i}.third_layernorm.* / fourth_layernorm.*
      transformer.layers.{i}.mlp.dense_h_to_4h.* [4H, H] / dense_4h_to_h.* [H, 4H]
      transformer.final_layernorm.*

    Target: stacked [L, ...] leaves, matrices [in, out], the fused qkv
    [L, H, 3, H] (q, k, v rows of the [3H, H] weight, as ColumnParallelLinear
    with stride 3 stores them at one model-parallel rank).

    Memory contract (the released cogview-base file is 7.8 GB in fp16, 3.93 B
    parameters): each stacked leaf is preallocated on ``device`` in its
    dtype and filled layer by layer; each source tensor goes to the device
    as it is stored, and is transposed or reshaped there, so the host holds
    no copy beside the source; with ``consume=True`` each source tensor is
    dropped from ``sd`` as soon as it is copied.  Nothing casts a float16 or
    bfloat16 tree to float32.  ``num_heads`` is not needed by the layout; it
    is taken for the JAX function's signature."""
    del num_heads
    if consume and isinstance(sd, dict):
        # re-key in place: a stripped copy would keep every tensor alive
        # through the caller's dict, defeating the per-tensor free
        if sd and next(iter(sd)).startswith("module."):
            for k in list(sd.keys()):
                sd[k[len("module."):]] = sd.pop(k)
    else:
        sd = strip_module_prefix(sd)

    def take(key):
        t = torch.as_tensor(sd[key]).to(device=device, dtype=dtype)
        if consume:
            del sd[key]
        return t

    word = take("word_embeddings.weight")
    hidden = word.shape[1]

    def stack(fmt, transform):
        """Preallocate [L, ...] and fill it layer by layer."""
        first = transform(take(fmt.format(0)))
        out = torch.empty((num_layers,) + tuple(first.shape), dtype=first.dtype,
                          device=first.device)
        out[0].copy_(first)
        del first
        for i in range(1, num_layers):
            out[i].copy_(transform(take(fmt.format(i))))
        return out

    def lin_w(a):  # torch Linear [out, in] -> [in, out]
        return a.t()

    def qkv_w(a):  # [3H, H] -> [in = H, 3, H]
        return a.t().reshape(hidden, 3, hidden)

    def qkv_b(a):
        return a.reshape(3, hidden)

    def ident(a):
        return a

    L = "transformer.layers.{}"
    return {
        "embed": {"word": word, "pos": take("transformer.position_embeddings.weight")},
        "layers": {
            "ln_in": {
                "g": stack(L + ".input_layernorm.weight", ident),
                "b": stack(L + ".input_layernorm.bias", ident),
            },
            "qkv": {
                "w": stack(L + ".attention.query_key_value.weight", qkv_w),
                "b": stack(L + ".attention.query_key_value.bias", qkv_b),
            },
            "attn_out": {
                "w": stack(L + ".attention.dense.weight", lin_w),
                "b": stack(L + ".attention.dense.bias", ident),
            },
            "ln_attn": {  # third_layernorm (sandwich, after attention)
                "g": stack(L + ".third_layernorm.weight", ident),
                "b": stack(L + ".third_layernorm.bias", ident),
            },
            "ln_post": {
                "g": stack(L + ".post_attention_layernorm.weight", ident),
                "b": stack(L + ".post_attention_layernorm.bias", ident),
            },
            "mlp_in": {
                "w": stack(L + ".mlp.dense_h_to_4h.weight", lin_w),
                "b": stack(L + ".mlp.dense_h_to_4h.bias", ident),
            },
            "mlp_out": {
                "w": stack(L + ".mlp.dense_4h_to_h.weight", lin_w),
                "b": stack(L + ".mlp.dense_4h_to_h.bias", ident),
            },
            "ln_mlp": {  # fourth_layernorm (sandwich, after the MLP)
                "g": stack(L + ".fourth_layernorm.weight", ident),
                "b": stack(L + ".fourth_layernorm.bias", ident),
            },
        },
        "ln_final": {
            "g": take("transformer.final_layernorm.weight"),
            "b": take("transformer.final_layernorm.bias"),
        },
    }


def load_gpt_checkpoint(path: str, num_layers: int, num_heads: int,
                        dtype: Optional[torch.dtype] = None, device=None) -> Params:
    """A DeepSpeed ``mp_rank_00_model_states.pt`` (generate_samples.py:56-61)
    or a plain module checkpoint (utils.py:203-220) -> GPT params on
    ``device``.

    For trusted files only: DeepSpeed checkpoints hold non-tensor objects
    (the training arguments among them), so this loads with
    ``weights_only=False``, which can run code stored in the file.

    Streams: ``torch.load(mmap=True)`` where the zip format allows it (a
    tensor's pages are read from the file when it is copied), each tensor
    is consumed out of the state dict as it converts, and the stored dtype
    is kept: peak host RSS stays within about 1.2x the file above what the
    process held before.  A legacy (non-zip) file has no mmap path and is
    read whole."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    except (TypeError, RuntimeError):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("module", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return gpt_from_state_dict(ckpt, num_layers, num_heads, dtype=dtype, consume=True,
                               device=device)
