"""Pipeline parallelism, a GPipe schedule over the mesh's 'pipe' axis (twin
of cogview_tpu/parallel/pipeline.py).

The model's stacked [L, ...] layer leaves are the stage decomposition:
split over 'pipe' on their leading dim (parallel/sharding.py), each rank
holds a contiguous block of L/p layers.  M microbatches stream through the
p stages in M + p - 1 ticks; at tick t stage s runs microbatch t - s, and
the activations hop one stage a tick through ``comm.ppermute``.  The last
stage's outputs reach every stage through one all-reduce over 'pipe'.

Every rank runs the same collectives in the same order, forward and
backward: each tick's ppermute result is read on every stage through a
tensor-valued ``torch.where`` (stage 0 takes the microbatch in place of
what it received), so its backward runs on every stage as well; a Python
branch on the stage there would leave stage 0's autograd without that
ppermute's backward, and the other stages waiting for it.  The compute
does branch on the stage: a stage skips the warm-up and drain ticks that
the JAX scan computes on values it never reads (the bubble).  The warm-up
buffer is microbatch 0's real activations, not zeros: zeros turn to NaN
through the PB-relax LayerNorm, whose eps scales by max|x|^2.

Under data parallelism a rank's rows are its shard of every microbatch
(:func:`data_rows`): the JAX pipeline cuts the *global* batch into M
microbatches, and GSPMD then splits each one over 'data'.  So the rank's
rows chunk into its shards of microbatches 0..M-1, and every dropout mask
hashes the coordinates that the JAX package hashes (:func:`shard_rows`
says where the shard lies when the microbatch does not split evenly).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from . import comm
from .mesh import DATA_AXIS, PIPE_AXIS, Mesh, current_mesh

_M32 = 0xFFFFFFFF


def microbatch_seed(seed: int, m: int) -> int:
    """The dropout seed of a layer whose seed is ``seed`` on microbatch
    ``m``.  The JAX pipeline xors m into every word d[i] of the layer's key
    data and then derives the seed as ``seed_from_key(d) = d[-1] ^ (d[0] <<
    1)``, so the seed becomes (d[-1] ^ m) ^ ((d[0] ^ m) << 1) = seed ^ m ^
    (m << 1), in 32 bits."""
    return (seed ^ m ^ ((m << 1) & _M32)) & _M32


def data_rows(batch_size: int, microbatches: int = 0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The rows of a global batch of ``batch_size`` that this data rank
    trains, in its order.  Without a 'pipe' axis the contiguous block
    [d B/dp, (d + 1) B/dp).  With one, and ``microbatches`` M (0: one per
    stage), the JAX pipeline's rows: rank d holds rows m n + [d n / dp,
    (d + 1) n / dp) (rounded down) of each microbatch m of n = B/M rows in
    turn, so that its rows chunk into its shards of the M microbatches.
    Where dp divides n these are GSPMD's shards; where it does not, GSPMD
    pads its last shards and the ranks here hold shards one row apart in
    size: the rows' global coordinates, which the dropout masks hash, are
    the same.  Where a microbatch holds fewer rows than there are data
    ranks, the first ranks hold empty shards of it, as GSPMD's padded
    shards hold no row of the batch."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return torch.arange(batch_size)
    M = (microbatches or mesh.pipe) if mesh.pipe > 1 else 1
    n, dp, d = batch_size // M, mesh.data, mesh.data_rank
    if n * M != batch_size or (M == 1 and n % dp):
        raise ValueError(f"{batch_size} rows do not split into {M} microbatches x "
                         f"{dp} data ranks")
    lo, hi = d * n // dp, (d + 1) * n // dp
    return (torch.arange(M)[:, None] * n + torch.arange(lo, hi)).reshape(-1)


def shard_rows(rows: int, device=None) -> Tuple[int, int]:
    """(first row, rows) in a pipeline microbatch of this data rank's shard
    of ``rows`` rows: the ranks' shards lie in rank order (:func:`data_rows`)
    and may differ in size, so it takes one all-reduce over 'data'."""
    mesh = current_mesh()
    if mesh is None or mesh.data == 1:
        return 0, rows
    counts = torch.zeros(mesh.data, dtype=torch.int64, device=device)
    counts[mesh.data_rank] = rows
    counts = comm.all_reduce(counts, DATA_AXIS).tolist()
    return sum(counts[:mesh.data_rank]), sum(counts)


def gpipe(stage_fn: Callable[..., torch.Tensor], h: torch.Tensor, n_microbatches: int,
          mb_aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``h`` [B, S, H] (replicated over 'pipe') through every stage's layers
    -> [B, S, H], replicated over 'pipe'.

    ``stage_fn(act, m, *chunks)`` applies this stage's layers to microbatch
    ``m``'s activations ``act`` [B/M, S, H]; ``chunks`` are the rows of
    microbatch m of each ``mb_aux`` tensor (leading dim B: per-sample state
    such as the sparse pivots)."""
    mesh = current_mesh()
    p, s = mesh.pipe, mesh.pipe_rank
    M = n_microbatches
    B = h.shape[0]
    if B % M:
        raise ValueError(f"{B} rows do not split into {M} pipeline microbatches")
    for a in mb_aux:
        if a.shape[0] != B:
            raise ValueError(f"a per-sample input of {a.shape[0]} rows for {B} rows")
    x = comm.copy_to_pipe(h).chunk(M)
    aux = [a.chunk(M) for a in mb_aux]
    first = torch.tensor(s == 0, device=h.device)
    buf = x[0]
    outs = [None] * M
    for t in range(M + p - 1):
        act = torch.where(first, x[min(t, M - 1)], buf)
        m = t - s
        if 0 <= m < M:
            act = stage_fn(act, m, *(c[m] for c in aux))
        if t >= p - 1:
            outs[t - (p - 1)] = act
        if t < M + p - 2:  # the last tick's hop would never be read
            buf = comm.ppermute(act, PIPE_AXIS, 1)
    out = torch.cat(outs)
    last = torch.tensor(s == p - 1, device=h.device)
    return comm.sum_over_pipe(torch.where(last, out, out.new_zeros(())))
