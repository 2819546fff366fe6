"""Models: transformation, GMM likelihood, regularisers, priors, samplers."""

from .distributions import (DirichletPrior, LogEnergyExpGammaPrior, LogPrecisionExpGammaPrior,
                            LogScaleNormalPrior, NormalDistribution, make_distribution)
from .gmm import GMM
from .reg_loss import (RegLossL2, RegLossLogNormal, RegLossLogNormalL2, RegLossStudent,
                       make_reg_loss)
from .transformation import SVF2D, SVF3D, SVFFD3D, BSplineFFD3D, make_transformation

__all__ = [
    "SVF3D",
    "SVF2D",
    "SVFFD3D",
    "BSplineFFD3D",
    "make_transformation",
    "GMM",
    "RegLossL2",
    "RegLossLogNormal",
    "RegLossLogNormalL2",
    "RegLossStudent",
    "DirichletPrior",
    "LogScaleNormalPrior",
    "LogEnergyExpGammaPrior",
    "LogPrecisionExpGammaPrior",
    "NormalDistribution",
    "make_distribution",
    "make_reg_loss",
]
