"""Process groups of a ('data', 'pipe', 'seq', 'model') mesh (twin of
cogview_tpu/parallel/mesh.py).

The JAX package reshapes its devices to [dp, pp, sp, mp] with 'model'
innermost, so a tensor-parallel group is mp adjacent devices.  Here rank
``r = ((d * pp + p) * sp + s) * mp + m`` holds data coordinate d, pipeline
stage p, sequence shard s and model coordinate m: the model groups are
runs of mp consecutive ranks, the data groups stride pp * sp * mp, as the
reference's mpu process groups are laid out.  With pp = sp = 1 this is
``r = d * mp + m``.  :func:`use_mesh` makes a mesh ambient (the twin of
``jax.set_mesh``); the model, the losses, the train step and the sampler
read it through :func:`current_mesh`.

``fsdp`` is part of the mesh here, where the JAX package keeps it in the
param shardings (``gpt_param_specs(fsdp_axis=)``): the port's leaves are
plain tensors that carry no sharding of their own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS)  # outermost first

Axes = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a dp x pp x sp x mp mesh.  ``groups`` maps an
    axis name, or the tuple (data, seq), to the process group of this
    rank's line (or plane) along it (None for a size of 1) and ``"world"``
    to the default group."""

    data: int
    model: int
    rank: int
    fsdp: bool
    device: torch.device
    groups: Any
    pipe: int = 1
    seq: int = 1

    def size(self, axis: str) -> int:
        if axis == "world":
            return self.world
        return getattr(self, axis)

    def stride(self, axis: str) -> int:
        """The rank distance between neighbours along ``axis``."""
        inner = AXES[AXES.index(axis) + 1:]
        out = 1
        for a in inner:
            out *= getattr(self, a)
        return out

    def axis_rank(self, axis: str) -> int:
        if axis == "world":
            return self.rank
        return (self.rank // self.stride(axis)) % getattr(self, axis)

    @property
    def data_rank(self) -> int:
        return self.axis_rank(DATA_AXIS)

    @property
    def pipe_rank(self) -> int:
        return self.axis_rank(PIPE_AXIS)

    @property
    def seq_rank(self) -> int:
        return self.axis_rank(SEQ_AXIS)

    @property
    def model_rank(self) -> int:
        return self.axis_rank(MODEL_AXIS)

    @property
    def world(self) -> int:
        return self.data * self.pipe * self.seq * self.model

    def peer(self, axis: str, coord: int) -> int:
        """The global rank of coordinate ``coord`` (mod the axis size) along
        ``axis``, this rank's other coordinates kept."""
        n, stride = getattr(self, axis), self.stride(axis)
        return self.rank + ((coord % n) - self.axis_rank(axis)) * stride

    def group(self, axis: Axes):
        return self.groups[axis]


def _lines(sizes: Sequence[int], along: Sequence[int]):
    """The rank lists of every line (or plane) along the dims ``along`` of
    a row-major grid of ``sizes``, in row-major order of the other dims."""
    other = [i for i in range(len(sizes)) if i not in along]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    for fixed in itertools.product(*(range(sizes[i]) for i in other)):
        base = sum(c * strides[i] for c, i in zip(fixed, other))
        yield sorted(base + sum(c * strides[i] for c, i in zip(cs, along))
                     for cs in itertools.product(*(range(sizes[i]) for i in along)))


def create_mesh(model_parallel: int = 1, data_parallel: Optional[int] = None,
                fsdp: bool = False, device=None, seq_parallel: int = 1,
                pipe_parallel: int = 1) -> Mesh:
    """The mesh over every rank of the default process group (one rank and
    no groups where torch.distributed is not initialized).  Every rank must
    call it, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    par = model_parallel * seq_parallel * pipe_parallel
    if data_parallel is None:
        if world % par:
            raise ValueError(f"{world} ranks do not divide into model_parallel "
                             f"{model_parallel} x seq_parallel {seq_parallel} x "
                             f"pipe_parallel {pipe_parallel}")
        data_parallel = world // par
    if data_parallel * par != world:
        raise ValueError(f"mesh {data_parallel} x {pipe_parallel} x {seq_parallel} x "
                         f"{model_parallel} != {world} ranks")
    sizes = (data_parallel, pipe_parallel, seq_parallel, model_parallel)
    groups = {a: None for a in AXES}
    groups[(DATA_AXIS, SEQ_AXIS)] = None
    groups["world"] = dist.group.WORLD if world > 1 else None
    if world > 1:
        # every rank creates every group, in one order: 'model' lines, then
        # 'data', then 'seq', 'pipe' and the (data, seq) planes (the first
        # two are the whole layout where pp = sp = 1)
        order = ((MODEL_AXIS,), (DATA_AXIS,), (SEQ_AXIS,), (PIPE_AXIS,),
                 (DATA_AXIS, SEQ_AXIS))
        for axes in order:
            dims = [AXES.index(a) for a in axes]
            if any(sizes[i] == 1 for i in dims):
                continue
            for ranks in _lines(sizes, dims):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes[0] if len(axes) == 1 else axes] = g
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return Mesh(data_parallel, model_parallel, rank, bool(fsdp), dev, groups,
                pipe=pipe_parallel, seq=seq_parallel)


_CURRENT: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside :func:`use_mesh`."""
    return _CURRENT


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` ambient for the block (None: no mesh)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev
