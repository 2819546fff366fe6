"""The step's least time (operations or bytes, whichever bounds it) over its untraced time, in %. (step: one SG-MCMC transition.)"""

from perfbench import layers


def read(ctx):
    return layers.step_mfu(ctx, "mcmc")
