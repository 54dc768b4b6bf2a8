"""Model configuration dataclasses and presets (twin of cogview_tpu/config.py).

Only the fields the ported slices read are mirrored (of the parallelism
axes only the sharded decode's; no flash block sizes: they tune the TPU
kernel's VMEM blocks);
``compute_dtype`` is a torch dtype.  The presets keep the JAX package's
names and widths.
"""

from __future__ import annotations

import dataclasses

import torch


def pad_vocab_size(n: int, model_parallel: int = 1, multiple: int = 128) -> int:
    """Pad vocab to a multiple of 128*mp (reference pretrain_gpt2.py:690-698)."""
    m = multiple * model_parallel
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    num_layers: int
    hidden_size: int
    num_heads: int
    vocab_size: int
    max_position_embeddings: int = 1089
    layernorm_epsilon: float = 1e-5
    embedding_dropout: float = 0.1
    attention_dropout: float = 0.1
    output_dropout: float = 0.1
    sandwich_ln: bool = True  # third/fourth layernorm (Sandwich-LN)
    pb_relax: bool = True  # PB-relax LN prescale, folded into eps
    init_std: float = 0.02
    scaled_output_init: bool = True  # N(0, std/sqrt(2L)) for output mats
    # pivot + window sparse training attention (ops/sparse_attention.py)
    query_window: int = 128
    key_window_times: int = 6
    num_pivot: int = 768
    compute_dtype: torch.dtype = torch.bfloat16
    # flash attention for full causal forwards (scoring): "auto" picks it
    # iff the sequence length >= flash_min_seq; True/False force it
    use_flash_attention: "bool | str" = "auto"
    flash_min_seq: int = 1024
    # training CE over sequence chunks of (the largest divisor of S <=) this
    # many tokens; >= S forces full logits; 0 = auto: full logits while the
    # float32 [B, S, V] logits fit in 4.5 GiB, 160-token chunks above
    ce_chunk_target: int = 0
    # autoregressive KV cache: "bfloat16" (exact, in the compute dtype,
    # dense attention), "int8" (per-(head, token) absmax/127 scales, the K1
    # decode kernel) or "int4" (two values a byte, absmax/7 scales, the K2
    # decode kernel); the JAX package's default is "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    # GPipe microbatches of a training forward on a mesh with a 'pipe' axis
    # (parallel/pipeline.py); 0 = one per stage
    pp_microbatches: int = 0

    def __post_init__(self):
        assert self.hidden_size % self.num_heads == 0
        if self.kv_cache_dtype not in ("int8", "int4", "bfloat16"):
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}: int8, int4 or bfloat16")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return 4 * self.hidden_size

    def replace(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)


# unified vocab: 8192 image + 50000 text + 27 command = 58219 -> pad 58240
UNIFIED_VOCAB_RAW = 58219


def cogview_base(**kw) -> GPTConfig:
    """Released cogview-base scale: 48L x 2560H x 40 heads."""
    cfg = GPTConfig(
        num_layers=48,
        hidden_size=2560,
        num_heads=40,
        vocab_size=pad_vocab_size(UNIFIED_VOCAB_RAW),
    )
    return cfg.replace(**kw) if kw else cfg


def cogview_sr(**kw) -> GPTConfig:
    """Super-resolution: cogview-base with 1345 positions
    (scripts/super_resolution.sh:8)."""
    return cogview_base(max_position_embeddings=1345, **kw)


def cogview_tutorial(**kw) -> GPTConfig:
    """Tutorial pretraining scale: 12L x 1024H x 16 heads."""
    cfg = GPTConfig(
        num_layers=12,
        hidden_size=1024,
        num_heads=16,
        vocab_size=pad_vocab_size(UNIFIED_VOCAB_RAW),
    )
    return cfg.replace(**kw) if kw else cfg


def smoke(**kw) -> GPTConfig:
    """Tiny dims over the real unified vocab (random-init CLI runs)."""
    cfg = GPTConfig(
        num_layers=2,
        hidden_size=64,
        num_heads=4,
        vocab_size=pad_vocab_size(UNIFIED_VOCAB_RAW),
        embedding_dropout=0.0,
        attention_dropout=0.0,
        output_dropout=0.0,
    )
    return cfg.replace(**kw) if kw else cfg


def tiny_test(**kw) -> GPTConfig:
    """Small config for unit tests."""
    cfg = GPTConfig(
        num_layers=2,
        hidden_size=64,
        num_heads=8,
        vocab_size=128,
        max_position_embeddings=64,
        embedding_dropout=0.0,
        attention_dropout=0.0,
        output_dropout=0.0,
        compute_dtype=torch.float32,
    )
    return cfg.replace(**kw) if kw else cfg


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """Released cogview VQ-VAE hyperparameters (cogview_tpu/models/vqvae.py)."""

    in_channel: int = 3
    channel: int = 512
    n_res_block: int = 0
    embed_dim: int = 256
    n_embed: int = 8192
    stride: int = 6  # => 3 stride-2 convs, spatial /8
    simple: bool = True

    @property
    def downscale(self) -> int:
        return 8

    def code_side(self, img_size: int) -> int:
        return img_size // self.downscale
