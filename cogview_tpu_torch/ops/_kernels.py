"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build runs at first use, from the sources in the checkout, into
``cogview_tpu_torch/build/`` (which git ignores); the library's file name
carries a hash of its source and flags, so an edited source is rebuilt.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# No --use_fast_math: the decode seal's division and round-half-even, and
# the flash kernels' expf / logf and dropout division, must be IEEE so the
# kernels agree with their plain PyTorch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)

# library -> {exported C function: argtypes}; every function returns the
# cudaError_t of its launch as an int
SIGNATURES: Dict[str, Dict[str, List]] = {
    "decode_attention": {
        # q, q_is_bf16, ring, kv, scales, ctx, split partials, split
        # counters, B, N, D, NW, index, splits, stream
        "decode_attention_int8": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # the packed int4 cache, same arguments
        "decode_attention_int4": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        # q, k, v, o, lse, is_bf16, B, S, N, D,
        # q/k/v batch and sequence strides (elements),
        # sep, scale, seed, threshold, keep, dropout, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L,
                                _I, _F, _U, _U, _F, _I, _P],
        # q, k, v, dO, lse, delta, dq, is_bf16, B, S, N, D,
        # q/k/v/dO batch and sequence strides, then as the forward
        "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L,
                                   _I, _F, _U, _U, _F, _I, _P],
        # q, k, v, dO, lse, delta, dk, dv, is_bf16, B, S, N, D, then as dq
        "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _L, _L, _L, _L,
                                    _I, _F, _U, _U, _F, _I, _P],
    },
    "probes": {
        # x, o, n, stream
        "probe_add_one": [_P, _P, _I, _P],
        # the TPU probe's calling convention (the decode kernels' arguments
        # before their split over windows): q, q_is_bf16, ring, kv, scales,
        # ctx, B, N, D, NW, G, index, stream
        "probe_decode_convention": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # qc, oh, lane0, out, G, hb, Dc, W, stream
        "probe_seal_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one ``nvcc``
    per source, all started together -> the library paths."""
    names = list(names)
    outs = [_target(n) for n in names]
    jobs = []
    try:
        for name, out in zip(names, outs):
            if out.exists():
                continue
            BUILD.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            jobs.append((subprocess.Popen(cmd), cmd, tmp, out))
        for proc, cmd, tmp, out in jobs:
            if proc.wait() != 0:
                raise subprocess.CalledProcessError(proc.returncode, cmd)
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for proc, _, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its functions' argtypes set, built
    on first use."""
    if name not in _LIBS:
        so = ctypes.CDLL(str(build_all([name])[0]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(so, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I
        _LIBS[name] = so
    return _LIBS[name]
