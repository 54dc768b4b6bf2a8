"""Sharding rules of the GPT's parameters and caches (twin of
cogview_tpu/parallel/sharding.py).

A spec is a tuple with one entry per dim of a leaf: ``"model"``, ``"data"``
or None (replicated along that dim), the JAX package's PartitionSpec.
Megatron's tensor parallelism:

  the word embedding   vocab rows over 'model' (VocabParallelEmbedding)
  qkv.w [L, H, 3, H]   its last dim over 'model': the fused dim is
                       (heads, head_dim) with heads contiguous, so a slice
                       holds whole heads of each of q, k and v
  mlp_in.w             its output dim over 'model' (ColumnParallelLinear)
  attn_out.w, mlp_out.w  their input dim over 'model' (RowParallelLinear;
                       the sum of the partial products is the all-reduce of
                       parallel/comm.py)

with the biases of column-parallel matmuls split like their outputs and
everything else replicated.  ``pipe=True`` splits every layer leaf's
leading L dim over 'pipe' (the pipeline's stages, parallel/pipeline.py).
``fsdp=True`` also splits the other dim of
every weight matrix and of both embedding tables over 'data' (FSDP /
ZeRO-3); the model gathers a layer's weights inside its layer loop.  Int8
weight-only leaves (``{"w8", "s"}``) split ``w8`` as ``w`` and their
scales follow their output channels; they take no FSDP.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh

Spec = Tuple[Optional[str], ...]

M = MODEL_AXIS


def gpt_param_specs(fsdp: bool = False, quantized: bool = False,
                    pipe: bool = False) -> Dict[str, Any]:
    """The spec tree of ``models.gpt.init_params``'s layout, or of
    ``gpt.quantize_weights``'s with ``quantized``; ``pipe`` splits the
    layer leaves' L dim over 'pipe'."""
    F = DATA_AXIS if fsdp and not quantized else None
    Pp = PIPE_AXIS if pipe else None
    ln = {"g": (Pp, None), "b": (Pp, None)}

    def mat(w: Spec, s: Spec, b: Spec):
        w, s, b = (Pp,) + w[1:], (Pp,) + s[1:], (Pp,) + b[1:]
        return {"w8": w, "s": s, "b": b} if quantized else {"w": w, "b": b}

    word = {"w8": (M, None), "s": (M,)} if quantized else (M, F)
    return {
        "embed": {"word": word, "pos": (None, F)},
        "layers": {
            "ln_in": dict(ln),
            "qkv": mat((None, F, None, M), (None, None, M), (None, None, M)),
            "attn_out": mat((None, M, F), (None, None), (None, None)),
            "ln_attn": dict(ln),
            "ln_post": dict(ln),
            "mlp_in": mat((None, F, M), (None, M), (None, M)),
            "mlp_out": mat((None, M, F), (None, None), (None, None)),
            "ln_mlp": dict(ln),
        },
        "ln_final": {"g": (None,), "b": (None,)},
    }


def specs_for(params, mesh: Mesh) -> Dict[str, Any]:
    """The spec tree of ``params`` (float or int8 weight-only) on ``mesh``'s
    layout: FSDP where it shards weights, layers over 'pipe' where it has
    stages."""
    return gpt_param_specs(mesh.fsdp, quantized=isinstance(params["embed"]["word"], dict),
                           pipe=mesh.pipe > 1)


def layer_fsdp_dim(name: str) -> Optional[int]:
    """The dim of a per-layer weight view ``layers[name]["w"][li]`` split
    over 'data' under FSDP (the stacked L dim dropped), or None."""
    spec = gpt_param_specs(fsdp=True)["layers"][name].get("w")
    if spec is None or DATA_AXIS not in spec:
        return None
    return spec.index(DATA_AXIS) - 1


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def spec_leaves(tree, specs):
    """The specs in ``optim.tree_leaves``'s order (sorted keys)."""
    out = []

    def walk(t, s):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], s[k])
            else:
                out.append(s[k])

    walk(tree, specs)
    return out


def shard_leaf(x, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a full leaf (numpy or torch), a contiguous
    tensor of its own on the mesh's device."""
    t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = mesh.size(axis), mesh.axis_rank(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over "
                             f"{axis}={n}")
        size = t.shape[dim] // n
        t = t.narrow(dim, r * size, size)
    return t.to(mesh.device).contiguous().clone()


def shard_params(params, mesh: Mesh, specs=None):
    """Full leaves (numpy or torch) -> this rank's shards; specs default to
    the mesh's layout (:func:`specs_for`)."""
    specs = specs if specs is not None else specs_for(params, mesh)
    return _map(lambda x, s: shard_leaf(x, s, mesh), params, specs)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full leaf from every rank's shard (a collective: every rank
    calls it), a tensor of its own."""
    out = x
    for dim, axis in enumerate(spec):
        if axis is not None:
            out = comm.all_gather(out, axis, dim, mesh)
    return out.clone() if out is x else out


def gather_params(params, mesh: Mesh, specs=None, device=None):
    """This rank's shards -> the full leaves, on every rank, each moved to
    ``device`` as soon as it is gathered (a checkpoint's leaves go to the
    host one at a time, so no card holds every full leaf at once)."""
    specs = specs if specs is not None else specs_for(params, mesh)
    return _map(lambda x, s: gather_leaf(x.detach(), s, mesh).to(device or x.device),
                params, specs)


def cache_spec(cache) -> Dict[str, Spec]:
    """Specs of a KV cache's tensors: batch rows over 'data', heads over
    'model' (int8/int4 data [L, NW, B, 2, N, Dc, W], scales [L, NW, B, 2,
    N, W], ring [L, G, B, N, 2D]; bfloat16 K and V [L, B, H, T], whose
    heads-major H slices whole heads)."""
    from ..models.gpt import KVCache

    D = DATA_AXIS
    if isinstance(cache, KVCache):
        return {"k": (None, D, M, None), "v": (None, D, M, None)}
    return {"kv": (None, None, D, None, M, None, None),
            "scale": (None, None, D, None, M, None),
            "recent": (None, None, D, M, None)}
