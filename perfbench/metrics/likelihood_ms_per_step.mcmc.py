"""Device ms per step of the likelihood stage (the LCC residuals, VD and the GMM's NLL, priors and Adam step), its backward kernels included. (step: one SG-MCMC transition.)"""

from perfbench import stages


def read(ctx):
    return stages.ms_per_step(ctx, "mcmc", "likelihood")
