"""cogview_tpu_torch — the PyTorch + CUDA port of cogview_tpu.

The package follows the JAX package's module layout and names, so each
module's counterpart is easy to find (``cogview_tpu/ops/hash_prng.py`` ->
``cogview_tpu_torch/ops/hash_prng.py``).  It imports ``torch`` and never
``jax``; the only piece of ``cogview_tpu`` it reuses is the framework-free
``cogview_tpu.tokenization`` package.

The slice ported so far is the text->image serving path: template
compilation, int8-KV-cache prefill, the 1024-step decode loop (whose decode
attention is the hand-written CUDA kernel in ``csrc/decode_attention.cu``),
and the VQ-VAE decoder.
"""

__version__ = "0.1.0"
