"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build runs
at first use, from the sources in the checkout, into
``cogview_tpu_torch/build/`` (which git ignores); the library's file name
carries a hash of its source, so an edited source is rebuilt.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# No --use_fast_math: the seal's division and round-half-even must be IEEE
# so the quantized bytes equal the plain PyTorch version's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build(name: str = "decode_attention") -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) -> the library path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)], check=True)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded decode-attention library, built on first use."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build("decode_attention")))
        fn = so.decode_attention_int8
        P, I = ctypes.c_void_p, ctypes.c_int
        # q, q_is_bf16, ring, kv, scales, ctx, B, N, D, NW, G, index, stream
        fn.argtypes = [P, I, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        _LIB = so
    return _LIB
