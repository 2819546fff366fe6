"""Engines: model bundle, the shared forward chain, VI and SG-MCMC."""

from .bundle import ModelBundle
from .mcmc import (
    MCMCState,
    init_chains,
    make_mcmc_chunk,
    make_sgld_transition,
    make_sgld_transition_shared,
    posterior_statistics,
)
from .pairs import (make_pair_mcmc_chunk, make_pair_mesh, make_pair_vi_chunk, pair_device_count,
                    shard_pairs, stack_trees, unstack_tree)
from .vi import (VIState, count_folds, forward_sample, gmm_warmup, make_vi_chunk,
                 make_vi_step)

__all__ = [
    "stack_trees",
    "unstack_tree",
    "pair_device_count",
    "make_pair_mesh",
    "shard_pairs",
    "make_pair_vi_chunk",
    "make_pair_mcmc_chunk",
    "ModelBundle",
    "MCMCState",
    "init_chains",
    "make_mcmc_chunk",
    "make_sgld_transition",
    "make_sgld_transition_shared",
    "posterior_statistics",
    "count_folds",
    "forward_sample",
    "VIState",
    "make_vi_step",
    "make_vi_chunk",
    "gmm_warmup",
]
