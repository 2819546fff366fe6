"""The multi-device layer (port of ``ir_sgmcmc_tpu/parallel``): device
meshes, the placement of state over them, and spatially sharded stencil ops
by explicit halo exchange."""

from .halo import gradient_d_sharded, separable_conv3d_sharded, warp_bounded_sharded
from .mesh import (
    Mesh,
    Sharded,
    gather,
    make_mesh,
    replicate,
    shard_chain_state,
    shard_images_spatial,
    shard_state_spatial,
    shard_tree_spatial,
)

__all__ = [
    "make_mesh",
    "shard_chain_state",
    "shard_state_spatial",
    "shard_images_spatial",
    "shard_tree_spatial",
    "replicate",
    "separable_conv3d_sharded",
    "gradient_d_sharded",
    "warp_bounded_sharded",
    "Mesh",
    "Sharded",
    "gather",
]
