"""Process groups of a ('data', 'model') mesh (twin of
cogview_tpu/parallel/mesh.py).

The JAX package reshapes its devices to [dp, mp] with 'model' innermost, so
a tensor-parallel group is mp adjacent devices.  Here rank ``r = d * mp +
m`` holds data coordinate d and model coordinate m: the model groups are
runs of mp consecutive ranks, the data groups stride mp, as the reference's
mpu process groups are laid out.  :func:`use_mesh` makes a mesh ambient
(the twin of ``jax.set_mesh``); the model, the losses, the train step and
the sampler read it through :func:`current_mesh`.

``fsdp`` is part of the mesh here, where the JAX package keeps it in the
param shardings (``gpt_param_specs(fsdp_axis=)``): the port's leaves are
plain tensors that carry no sharding of their own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a dp x mp mesh.  ``groups`` maps an axis name to
    the process group of this rank's line along it (None for an axis of
    size 1) and ``"world"`` to the default group."""

    data: int
    model: int
    rank: int
    fsdp: bool
    device: torch.device
    groups: Any

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def world(self) -> int:
        return self.data * self.model

    def size(self, axis: str) -> int:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, "world": self.world}[axis]

    def axis_rank(self, axis: str) -> int:
        return {DATA_AXIS: self.data_rank, MODEL_AXIS: self.model_rank,
                "world": self.rank}[axis]

    def group(self, axis: str):
        return self.groups[axis]


def create_mesh(model_parallel: int = 1, data_parallel: Optional[int] = None,
                fsdp: bool = False, device=None) -> Mesh:
    """The mesh over every rank of the default process group (one rank and
    no groups where torch.distributed is not initialized).  Every rank must
    call it, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data_parallel is None:
        if world % model_parallel:
            raise ValueError(f"{world} ranks do not divide into model_parallel "
                             f"{model_parallel}")
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} != {world} ranks")
    groups = {DATA_AXIS: None, MODEL_AXIS: None,
              "world": dist.group.WORLD if world > 1 else None}
    if world > 1:
        mp, dp = model_parallel, data_parallel
        # every rank creates every group, in one order
        for d in range(dp):
            ranks = list(range(d * mp, (d + 1) * mp))
            g = dist.new_group(ranks) if mp > 1 else None
            if rank in ranks:
                groups[MODEL_AXIS] = g
        for m in range(mp):
            ranks = list(range(m, world, mp))
            g = dist.new_group(ranks) if dp > 1 else None
            if rank in ranks:
                groups[DATA_AXIS] = g
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return Mesh(data_parallel, model_parallel, rank, bool(fsdp), dev, groups)


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
