"""Device ms per step of the update stage (the draws, the loss, the gradient's seed and accumulation and the optimiser steps), its backward kernels included. (step: one SG-MCMC transition.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "mcmc", "update")
