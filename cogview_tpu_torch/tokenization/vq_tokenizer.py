"""PyTorch-backed image tokenizer for ``UnifiedTokenizer`` (twin of
cogview_tpu/tokenization/vq_tokenizer.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import VQVAEConfig
from ..models import vqvae


class TorchVQTokenizer:
    def __init__(self, params, cfg: VQVAEConfig = VQVAEConfig(), device=None):
        self.params = params
        self.cfg = cfg
        self.device = device
        self.num_tokens = cfg.n_embed

    @classmethod
    def random_init(cls, seed: int = 0, cfg: VQVAEConfig = VQVAEConfig(), device=None):
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        return cls(vqvae.init_params(cfg, gen, device), cfg, device)

    def __len__(self) -> int:
        return self.num_tokens

    def EncodeAsIds(self, img) -> np.ndarray:
        raise NotImplementedError(
            "the VQ-VAE encoder is not ported yet; it comes with the "
            "image->text slice (ROADMAP Queue A6)")

    def DecodeIds(self, code, shape=None) -> np.ndarray:
        """codes (list | [n] | [b, n]) -> de-normalized image [b, 8s, 8s, 3]."""
        code = np.asarray(code)
        if code.ndim == 1:
            code = code[None]
        if shape is not None:
            code = code.reshape(shape)
        codes = torch.as_tensor(code, dtype=torch.int64, device=self.device)
        return vqvae.code2img(self.params, codes).cpu().numpy()
