"""float32 precision policy (twin of cogview_tpu/ops/precision.py).

The JAX package runs every all-float32 contraction at HIGHEST precision.
On an NVIDIA card, cuBLAS float32 matmuls and cuDNN float32 convolutions may
instead run in TF32 (about three decimal digits); cuDNN does so by default,
and the VQ-VAE decoder is all convolutions.  Entry points call
:func:`set_fp32_precision` once, before any work, so float32 means float32.
"""

from __future__ import annotations

import torch


def set_fp32_precision() -> None:
    """Turn TF32 off for both cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
