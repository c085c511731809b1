"""Distribution of the port: the reference's placement rules as DTensor
placements (``sharding``) and the context its model code runs in on
DTensors over a mesh (``spmd``)."""

from .sharding import (
    batch_axes,
    cache_shardings,
    input_shardings,
    opt_state_shardings,
    param_shardings,
)
from .spmd import ambient_mesh, sharded, use_mesh

__all__ = [
    "ambient_mesh",
    "batch_axes",
    "cache_shardings",
    "input_shardings",
    "opt_state_shardings",
    "param_shardings",
    "sharded",
    "use_mesh",
]
