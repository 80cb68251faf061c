"""Distribution substrate of the port: mesh and axis conventions, the
sharding rules and the collectives.

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
    batch_spec,
    kv_page_spec,
    param_shardings,
    sanitize,
    serve_param_specs,
    shard_params,
    spec_for_param,
    state_shardings,
)

__all__ = [
    "DeviceMesh", "ParallelPlan", "SINGLE_DEVICE", "all_gather", "batch_spec",
    "broadcast", "kv_page_spec", "param_shardings", "psum", "sanitize",
    "serve_param_specs", "serving_mesh", "serving_plan", "shard_params",
    "spec_for_param", "state_shardings",
]
