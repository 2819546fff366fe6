"""Device kernel, memcpy and memset events per step in the profiler trace. (step: one SG-MCMC transition.)"""

from perfbench import layers


def read(ctx):
    return layers.launches_per_step(ctx, "mcmc")
