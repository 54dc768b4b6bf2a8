"""cogview_tpu_torch — the PyTorch + CUDA port of cogview_tpu.

The package follows the JAX package's module layout and names, so each
module's counterpart is easy to find (``cogview_tpu/ops/hash_prng.py`` ->
``cogview_tpu_torch/ops/hash_prng.py``).  It imports ``torch`` and never
``jax``, and nothing of ``cogview_tpu``: where it needs a framework-free
module of the JAX package (the text tokenizer, the data loader, timers) it
keeps its own copy.

Ported so far: text->image serving (int8 and int4 KV-cache decode through
the CUDA kernels in ``csrc/decode_attention.cu``, the exact bfloat16 cache,
the VQ-VAE, the folder-watcher server ``cli/serve.py``), image->text and
post-selection (the flash forward in ``csrc/flash_attention.cu``), and
pretraining (``cli/pretrain.py``: dropout, remat, the LM loss, AdamW, the
float16 loss scaler, checkpoints, and the flash backward kernels in the
same CUDA source).
"""

__version__ = "0.1.0"
