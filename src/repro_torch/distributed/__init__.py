"""Distribution substrate of the port: mesh and axis conventions, the
sharding rules and the serving collectives.

The JAX package's ``distributed/compat.py`` (a ``shard_map`` shim across
JAX versions) has no counterpart: one host process drives every shard.
"""

from repro_torch.distributed.collectives import all_gather, broadcast, psum
from repro_torch.distributed.mesh import (
    SINGLE_DEVICE,
    DeviceMesh,
    ParallelPlan,
    serving_mesh,
    serving_plan,
)
from repro_torch.distributed.sharding import (
    kv_page_spec,
    sanitize,
    serve_param_specs,
    shard_params,
    spec_for_param,
)

__all__ = [
    "DeviceMesh", "ParallelPlan", "SINGLE_DEVICE", "all_gather", "broadcast",
    "kv_page_spec", "psum", "sanitize",
    "serve_param_specs", "serving_mesh", "serving_plan", "shard_params",
    "spec_for_param",
]
