"""Device ms per step of the smooth stage (the Sobolev smoothing of the sampled field), its backward kernels included. (step: one SG-MCMC transition.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "mcmc", "smooth")
