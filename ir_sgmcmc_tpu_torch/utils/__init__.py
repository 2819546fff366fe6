"""Host-side utilities: checkpoints, logging, metrics, NIfTI/VTK I/O and
artifact savers (figures are imported only where figures are recorded)."""

from .checkpoint import load_checkpoint, peek_meta, save_checkpoint
from .loggers import ScalarWriter, setup_logging
from .metrics import STRUCTURES, MetricTracker, average_surface_distance, calc_metrics, dice
from .nifti import read_nifti, write_nifti
from .vtk_io import read_vtk_field, write_vtk_field

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "peek_meta",
    "setup_logging",
    "ScalarWriter",
    "MetricTracker",
    "STRUCTURES",
    "dice",
    "calc_metrics",
    "average_surface_distance",
    "read_nifti",
    "write_nifti",
    "read_vtk_field",
    "write_vtk_field",
]
