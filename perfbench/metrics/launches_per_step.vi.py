"""Device kernel, memcpy and memset events per step in the profiler trace. (step: one VI iteration.)"""

from perfbench import layers


def read(ctx):
    return layers.launches_per_step(ctx, "vi")
