from .dataset import NiftiPairDataset, SyntheticPairDataset, make_dataset
from .synthetic import sphere, sphere_pair

__all__ = ["sphere", "sphere_pair", "NiftiPairDataset", "SyntheticPairDataset", "make_dataset"]
