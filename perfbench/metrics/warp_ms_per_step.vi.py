"""Device ms per step of the warp stage (the moving image's warp), its backward kernels included. (step: one VI iteration.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "vi", "warp")
