"""Device ms per step of the bookkeeping stage (fold and saturation counts, Welford, metrics and the per-call rows), its backward kernels included. (step: one VI iteration.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "vi", "bookkeeping")
