"""One minus device busy time per step over the untraced wall time per step, in %. (step: one VI iteration.)"""

from perfbench import layers


def read(ctx):
    return layers.device_idle_share(ctx, "vi")
