"""Device ms per step of the regulariser stage (the reg energy, its hyperpriors and the entropy), its backward kernels included. (step: one SG-MCMC transition.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "mcmc", "regulariser")
