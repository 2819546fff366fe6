"""The hand-written kernels' least time at their shapes over their device time, in %. (step: one SG-MCMC transition.)"""

from perfbench import layers


def read(ctx):
    return layers.kernel_roofline(ctx, "mcmc")
