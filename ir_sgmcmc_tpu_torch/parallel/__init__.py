"""The multi-device layer (port of ``ir_sgmcmc_tpu/parallel``): device
meshes, the placement of state over them, spatially sharded stencil ops
by explicit halo exchange, and (``spatial.py``) the SG-MCMC and VI steps
cut along D over them."""

from .halo import (
    block_residual_overflow_sharded,
    box_filter3d_sharded,
    fourier_energy_sharded,
    gradient_d_sharded,
    lag1_sums_sharded,
    separable_conv3d_sharded,
    split_compose_sharded,
    sum_sharded,
    taylor_compose_sharded,
    taylor_squaring_sharded,
    warp_block_gather_sharded,
    warp_bounded_sharded,
)
from .mesh import (
    Mesh,
    Sharded,
    gather,
    halo_images_spatial,
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
    "halo_images_spatial",
    "shard_tree_spatial",
    "replicate",
    "separable_conv3d_sharded",
    "gradient_d_sharded",
    "warp_bounded_sharded",
    "taylor_squaring_sharded",
    "taylor_compose_sharded",
    "split_compose_sharded",
    "warp_block_gather_sharded",
    "block_residual_overflow_sharded",
    "box_filter3d_sharded",
    "lag1_sums_sharded",
    "fourier_energy_sharded",
    "sum_sharded",
    "Mesh",
    "Sharded",
    "gather",
]
