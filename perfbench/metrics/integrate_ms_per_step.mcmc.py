"""Device ms per step of the integrate stage (scaling and squaring, the compositions and the spread), its backward kernels included. (step: one SG-MCMC transition.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "mcmc", "integrate")
