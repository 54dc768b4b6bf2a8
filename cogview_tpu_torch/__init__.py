"""cogview_tpu_torch — the PyTorch + CUDA port of cogview_tpu.

The package follows the JAX package's module layout and names, so each
module's counterpart is easy to find (``cogview_tpu/ops/hash_prng.py`` ->
``cogview_tpu_torch/ops/hash_prng.py``).  It imports ``torch`` and never
``jax``; the only pieces of ``cogview_tpu`` it reuses are the framework-free
``cogview_tpu.tokenization`` and ``cogview_tpu.data`` packages
(``cogview_tpu.utils`` cannot be reused: its ``__init__`` imports jax).

Ported so far: text->image serving (int8-KV-cache decode through the CUDA
kernel in ``csrc/decode_attention.cu``, the VQ-VAE), image->text and
post-selection (the flash forward in ``csrc/flash_attention.cu``), and
pretraining (``cli/pretrain.py``: dropout, remat, the LM loss, AdamW, the
float16 loss scaler, checkpoints, and the flash backward kernels in the
same CUDA source).
"""

__version__ = "0.1.0"
