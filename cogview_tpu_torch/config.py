"""Model configuration dataclasses and presets (twin of cogview_tpu/config.py).

Only the fields the inference slice reads are mirrored (no dropout rates:
the port has no training yet); ``compute_dtype`` is a torch dtype.  The
presets keep the JAX package's names and widths.
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
    sandwich_ln: bool = True  # third/fourth layernorm (Sandwich-LN)
    pb_relax: bool = True  # PB-relax LN prescale, folded into eps
    init_std: float = 0.02
    scaled_output_init: bool = True  # N(0, std/sqrt(2L)) for output mats
    compute_dtype: torch.dtype = torch.bfloat16
    # Only the int8 window-blocked cache is ported so far; the bfloat16
    # cache and the packed int4 cache come with later slices.
    kv_cache_dtype: str = "int8"

    def __post_init__(self):
        assert self.hidden_size % self.num_heads == 0
        if self.kv_cache_dtype != "int8":
            raise NotImplementedError(
                f"kv_cache_dtype={self.kv_cache_dtype!r}: the port has only "
                "the int8 cache so far; the bfloat16 cache (ROADMAP Queue A3) "
                "and the int4 cache (Queue A8) come with later slices")

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


def smoke(**kw) -> GPTConfig:
    """Tiny dims over the real unified vocab (random-init CLI runs)."""
    cfg = GPTConfig(
        num_layers=2,
        hidden_size=64,
        num_heads=4,
        vocab_size=pad_vocab_size(UNIFIED_VOCAB_RAW),
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
