"""Engines: model bundle, the shared forward chain, and SG-MCMC."""

from .bundle import ModelBundle
from .mcmc import (
    MCMCState,
    init_chains,
    make_mcmc_chunk,
    make_sgld_transition,
    posterior_statistics,
)
from .vi import count_folds, forward_sample

__all__ = [
    "ModelBundle",
    "MCMCState",
    "init_chains",
    "make_mcmc_chunk",
    "make_sgld_transition",
    "posterior_statistics",
    "count_folds",
    "forward_sample",
]
