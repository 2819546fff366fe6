"""Device memory peak over the untraced window, in GiB. (step: one SG-MCMC transition.)"""

from perfbench import layers


def read(ctx):
    return layers.peak_mem_gib(ctx, "mcmc")
