"""Measurement entry points of the port's CUDA kernels (``python -m
cogview_tpu_torch.scripts.<name>``): ``launch_probe``, ``seal_scatter_probe``
and ``decode_kernel_microbench``."""
