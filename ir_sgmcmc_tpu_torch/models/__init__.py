"""Models: transformation, GMM likelihood, regularisers, priors, samplers."""

from .distributions import (DirichletPrior, LogEnergyExpGammaPrior, LogPrecisionExpGammaPrior,
                            LogScaleNormalPrior, NormalDistribution)
from .gmm import GMM
from .reg_loss import RegLossL2, RegLossLogNormal, RegLossLogNormalL2, RegLossStudent
from .transformation import SVF3D, make_transformation

__all__ = [
    "SVF3D",
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
]
