"""Multi-device training and decode of the port (twin of
cogview_tpu/parallel): a ('data', 'model') mesh of torch.distributed
process groups, its explicit collectives, and the sharding rules of the
GPT's parameters and caches."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, current_mesh, use_mesh
from .sharding import cache_spec, gather_params, gpt_param_specs, shard_params

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "current_mesh",
    "use_mesh",
    "gpt_param_specs",
    "shard_params",
    "gather_params",
    "cache_spec",
]
