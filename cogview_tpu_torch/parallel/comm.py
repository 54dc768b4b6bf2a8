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
  backward reduce-scatters the gradient, and :func:`gather_seq`, the same
  over 'seq' for the sequence blocks of a layer that attends over the
  whole sequence;
* :func:`ppermute`: ``lax.ppermute``'s one-hop shift along an axis, whose
  backward shifts back (ring attention's K/V rotation, the pipeline's
  activation hop);
* :func:`copy_to_pipe` / :func:`sum_over_pipe`: the identity whose
  backward all-reduces over 'pipe', and the all-reduce whose backward is
  the identity; they bracket the GPipe schedule (parallel/pipeline.py).

Each is the identity where the mesh has no such axis (or there is no
mesh).  :func:`backend_for` is the one place a backend is chosen: NCCL when
every rank has its own card, gloo otherwise (the CPU, or ranks that share
a card, which NCCL refuses).  Every collective runs on its tensors where
they lie, gloo's on CUDA tensors too; a collective that a backend refuses
raises.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Axes, Mesh, current_mesh


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


def torchrun_env() -> Tuple[int, int, int, int]:
    """(world size, rank, local rank, ranks on this host) from torchrun's
    ``env://`` variables; (1, 0, 0, 1) outside torchrun."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return world, rank, local_rank, int(os.environ.get("LOCAL_WORLD_SIZE", world))


def join_torchrun(device) -> Tuple[torch.device, bool]:
    """Join torchrun's group as this process's rank -> (this rank's
    device, whether this call joined).  On CUDA each rank takes the card
    LOCAL_RANK (mod the card count); :func:`init_process_group` picks NCCL
    where every rank of the host has its own card, gloo otherwise.  A
    process that has joined a group already keeps it.  The CLIs check
    their layout before they call it."""
    world, rank, local_rank, local_world = torchrun_env()
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    joined = not dist.is_initialized()
    if joined:
        init_process_group(rank, world, device, ranks_on_host=local_world,
                           init_method="env://")
    return device, joined


def _axis(axis: Axes, mesh: Optional[Mesh] = None):
    """-> (size, group) of an axis, or of the plane of a tuple of axes (its
    axes of size 1 dropped), with the ambient mesh by default."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 1, None
    if isinstance(axis, tuple):
        axes = tuple(a for a in axis if mesh.size(a) > 1)
        if len(axes) != 1:
            n = 1
            for a in axes:
                n *= mesh.size(a)
            return n, (mesh.group(axes) if n > 1 else None)
        axis = axes[0]
    return mesh.size(axis), mesh.group(axis)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, axis: Axes, op: str = "sum", mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axis``, or in one collective over
    the plane of a tuple of axes ((data, seq): the sums of a
    sequence-parallel step)."""
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


def ppermute_route(device) -> str:
    """How :func:`ppermute` moves a tensor on ``device`` under the default
    group's backend: "p2p" (one ``batch_isend_irecv`` of a send and a
    receive) wherever the backend sends that device's tensors point to
    point: NCCL, and gloo on the CPU.  gloo's send and receive take host
    memory only (on CUDA tensors its TCP transport aborts the process,
    "writev: Bad address", torch 2.11 on an H100), while its all_gather
    takes CUDA tensors; so ranks that share a card under gloo take
    "all_gather": an all-gather over the axis, of which the rank keeps its
    neighbour's block."""
    if torch.device(device).type == "cuda" and dist.get_backend() != "nccl":
        return "all_gather"
    return "p2p"


def _shift(x: torch.Tensor, axis: str, shift: int, mesh: Mesh) -> torch.Tensor:
    n, group = mesh.size(axis), mesh.group(axis)
    r = mesh.axis_rank(axis)
    x = x.contiguous()
    if ppermute_route(x.device) == "all_gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return parts[(r - shift) % n]
    out = torch.empty_like(x)
    # a P2POp's peer is a global rank, not the rank within ``group``
    ops = [dist.P2POp(dist.isend, x, mesh.peer(axis, r + shift), group),
           dist.P2POp(dist.irecv, out, mesh.peer(axis, r - shift), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
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


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, current_mesh()
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim, mesh=ctx.mesh), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift, mesh):
        ctx.axis, ctx.shift, ctx.mesh = axis, shift, mesh
        return _shift(x, axis, shift, mesh)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.shift, ctx.mesh), None, None, None


class _CopyToPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = current_mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, PIPE_AXIS, mesh=ctx.mesh)


class _SumOverPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, PIPE_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g


def ppermute(x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """``x`` of the rank ``shift`` places back along ``axis`` (each rank
    sends to the one ``shift`` ahead, cyclically; ``lax.ppermute`` with
    ``perm = [(r, (r + shift) % n)]``); the backward shifts the gradient
    the other way.  Every rank of the axis must call it in the same order,
    and must use its result, so that every rank runs its backward too."""
    mesh = current_mesh()
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _PPermute.apply(x, axis, shift, mesh)


def copy_to_pipe(x: torch.Tensor) -> torch.Tensor:
    """Identity; the backward all-reduces over 'pipe' (the pipeline's input,
    which only the first stage reads)."""
    mesh = current_mesh()
    return x if mesh is None or mesh.pipe == 1 else _CopyToPipe.apply(x)


def sum_over_pipe(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over 'pipe' (the last stage's output, zeros elsewhere);
    the backward is the identity: every stage computes the same loss from
    the sum, and each passes its own gradient back."""
    mesh = current_mesh()
    return x if mesh is None or mesh.pipe == 1 else _SumOverPipe.apply(x)


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
    return _GatherScatter.apply(w, DATA_AXIS, dim % w.dim())


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The blocks of the sequence over 'seq' gathered along ``dim``; the
    backward reduce-scatters (sums) the gradient back to this rank's
    block.  A layer that cannot attend through the ring (a memory, sparse
    attention) attends over the gathered sequence instead."""
    mesh = current_mesh()
    if mesh is None or mesh.seq == 1:
        return x
    return _GatherScatter.apply(x, SEQ_AXIS, dim % x.dim())


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
