"""Parameter bridge: JAX package pytrees (as numpy) -> the port's tensors.

The tests feed the same numpy parameters to both packages.  A pytree from
``cogview_tpu`` becomes numpy with ``jax.tree.map(np.asarray, params)``;
the functions here take that numpy tree and never import jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def gpt_params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """GPT params: the port keeps the JAX tree, names and layouts
    (stacked [L, ...] leaves, ``qkv.w`` [L, H, 3, H], ``{w8, s}`` int8
    leaves), so this is a leaf-wise conversion."""
    return _tree(tree, lambda a: _tensor(a, device))


def gpt_params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse of :func:`gpt_params_from_jax`: the port's GPT params as a
    numpy tree with the same names and layouts.  bfloat16 leaves become
    float32, which holds every bfloat16 value exactly."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _tree(tree, leaf)


def vqvae_params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """VQ-VAE encoder, decoder and codebook.  Convs HWIO -> OIHW.
    Transposed convs are stored [kh, kw, out, in] in the JAX package and
    map to PyTorch's [in, out, kh, kw] by a pure permutation: both index
    taps the same way (out[2q] takes x[q] * W[1] + x[q-1] * W[3]), so no
    flip.  The codebook's EMA statistics (training state) are dropped."""

    def convs(part):
        # both layouts permute (3, 2, 0, 1)
        return {name: {"w": _tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1), device),
                       "b": _tensor(p["b"], device)}
                for name, p in part.items()}

    return {"encoder": convs(tree["encoder"]), "decoder": convs(tree["decoder"]),
            "quantize": {"embed": _tensor(tree["quantize"]["embed"], device)}}
