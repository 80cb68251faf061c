"""Distribution substrate of the port: mesh and axis conventions, the
sharding rules and the collectives.

The JAX package's ``distributed/compat.py`` (a ``shard_map`` shim across
JAX versions) has no counterpart: one host process drives every shard.
:class:`Blocked` (``blocked.py``), a leaf stored as its blocks over a
mesh, is the port's own (a sharded ``jax.Array`` needs no class there):
it is bound here but kept out of ``__all__``, which lists the JAX
package's names.
"""

from repro_torch.distributed.blocked import Blocked
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
