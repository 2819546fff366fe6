"""Device ms per step of PyTorch's own elementwise, copy and reduction kernels. (step: one SG-MCMC transition.)"""

from perfbench import layers


def read(ctx):
    return layers.plain_ops_ms_per_step(ctx, "mcmc")
