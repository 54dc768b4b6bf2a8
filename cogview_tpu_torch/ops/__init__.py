"""Tensor ops of the port: twins of cogview_tpu/ops plus the CUDA kernel loader."""
