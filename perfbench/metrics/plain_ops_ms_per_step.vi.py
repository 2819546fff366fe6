"""Device ms per step of PyTorch's own elementwise, copy and reduction kernels. (step: one VI iteration.)"""

from perfbench import layers


def read(ctx):
    return layers.plain_ops_ms_per_step(ctx, "vi")
