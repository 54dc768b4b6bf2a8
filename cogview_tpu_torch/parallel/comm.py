"""Every collective of the port, explicit, on torch.distributed.

The JAX package writes tensor parallelism and FSDP as sharding metadata and
lets GSPMD insert the collectives.  The port's parameters are stacked
``[L, ...]`` tensors, not a module per layer, so DTensor and FSDP2 do not
fit them; the collectives are written out here instead, as the reference
wrote Megatron's (mpu/mappings.py):

* :func:`copy_to_model` / :func:`reduce_from_model`: the identity forward
  whose backward all-reduces over 'model', and the all-reduce forward whose
  backward is the identity; they bracket a column-parallel matmul and
  follow a row-parallel one;
* :func:`gather_from_model`: all-gather of a vocab-parallel output, whose
  backward keeps this rank's slice;
* :func:`vocab_parallel_rows` and :func:`vocab_parallel_logits`: the
  embedding lookup and the tied logits of a vocab table split over 'model';
* :func:`fsdp_gather`: FSDP's all-gather of a weight over 'data', whose
  backward reduce-scatters the gradient.

Each is the identity where the mesh has no such axis (or there is no
mesh).  :func:`backend_for` is the one place a backend is chosen: NCCL when
every rank has its own card, gloo otherwise (the CPU, or ranks that share
a card, which NCCL refuses).  Every collective runs on its tensors where
they lie, gloo's on CUDA tensors too; a collective that a backend refuses
raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, current_mesh


def backend_for(device, ranks_on_host: int) -> str:
    """'nccl' where ``device`` is CUDA and the host has a card for each of
    its ``ranks_on_host`` ranks, else 'gloo'."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, device, *, ranks_on_host: Optional[int] = None,
                       init_method: Optional[str] = None, store=None) -> str:
    """Join the default group with the backend :func:`backend_for` picks ->
    that backend.  ``init_method`` (e.g. ``env://`` or
    ``tcp://localhost:<port>``) or ``store`` (a ``FileStore``) names the
    rendezvous."""
    backend = backend_for(device, world_size if ranks_on_host is None else ranks_on_host)
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    dist.init_process_group(**kw)
    return backend


def _axis(axis: str, mesh: Optional[Mesh] = None):
    """-> (axis size, group) with the ambient mesh by default."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 1, None
    return mesh.size(axis), mesh.group(axis)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum", mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axis``."""
    n, group = _axis(axis, mesh)
    if n == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather(x: torch.Tensor, axis: str, dim: int, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """The shards of ``axis`` concatenated along ``dim``, in axis order."""
    n, group = _axis(axis, mesh)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, axis: str, dim: int, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x`` summed over ``axis``."""
    n, group = _axis(axis, mesh)
    if n == 1:
        return x
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def all_finite(values: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> bool:
    """True iff every value is finite on every rank: one flag, all-reduced
    (min) over the world, so every rank takes the same decision."""
    ok = all(bool(torch.isfinite(v).all()) for v in values)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.world == 1:
        return ok
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=mesh.device)
    return bool(all_reduce(flag, "world", "min", mesh).item())


# --------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------- #


# each backward runs its collective on the mesh its forward saw (the
# autograd engine may run it on another thread)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = current_mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, MODEL_AXIS, mesh=ctx.mesh)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size, ctx.mesh = dim, x.shape[dim], current_mesh()
        return all_gather(x, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.model_rank
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim):
        ctx.dim, ctx.mesh = dim, current_mesh()
        return all_gather(w, DATA_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, DATA_AXIS, ctx.dim, mesh=ctx.mesh), None


def _model_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.model


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the backward all-reduces over 'model' (the input of a
    column-parallel matmul)."""
    return x if _model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over 'model' (the output of a row-parallel matmul); the
    backward is the identity."""
    return x if _model_size() == 1 else _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """All-gather over 'model' along ``dim``; the backward keeps this
    rank's slice."""
    return x if _model_size() == 1 else _GatherFromModel.apply(x, dim % x.dim())


def fsdp_gather(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A weight's FSDP shards gathered over 'data' along ``dim`` when the
    ambient mesh shards weights (``fsdp``); the backward reduce-scatters
    (sums) the gradient back to this rank's shard."""
    mesh = current_mesh()
    if mesh is None or not mesh.fsdp or mesh.data == 1:
        return w
    return _FsdpGather.apply(w, dim % w.dim())


def vocab_parallel_rows(lookup: Callable[[torch.Tensor], torch.Tensor], tokens: torch.Tensor,
                        vocab_local: int) -> torch.Tensor:
    """Embedding rows of a table split by vocab rows over 'model':
    ``lookup(local ids)`` reads this rank's rows [..., H]; ids outside its
    range give zeros, and the all-reduce over 'model' sums the one nonzero
    row of each token."""
    mesh = current_mesh()
    if mesh is None or mesh.model == 1:
        return lookup(tokens)
    local = tokens - mesh.model_rank * vocab_local
    inside = (local >= 0) & (local < vocab_local)
    rows = lookup(torch.where(inside, local, 0))
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return reduce_from_model(rows)


def vocab_parallel_logits(h: torch.Tensor, matmul: Callable[[torch.Tensor], torch.Tensor]
                          ) -> torch.Tensor:
    """Logits over a vocab split over 'model': ``matmul`` takes the
    replicated hidden states to this rank's vocab columns, and the columns
    of every rank are gathered along the last dim."""
    return gather_from_model(matmul(copy_to_model(h)), -1)
