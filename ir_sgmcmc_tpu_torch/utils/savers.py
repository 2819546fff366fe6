"""Structured artifact savers: NIfTI images and VTK fields (port of
``ir_sgmcmc_tpu/utils/savers.py``; same file names and directories).

Fixed and moving images and masks, per-sample warped images +
displacements + log|J| (``chain_i_sample_%07d_*``), the variational
posterior mean, and masked/unmasked displacement mean and std-dev maps.

Artifact dumps run on one background writer thread (``submit`` /
``flush``): the main loop only dispatches a save, and the device-to-host
copy happens on the writer thread.  A tensor handed to it must not be
updated in place afterwards; the port's engines never do.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path

import numpy as np
import torch

from .nifti import write_nifti
from .vtk_io import write_vtk_field

_log = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    """A numpy copy of ``x`` (a tensor on any device, or array-like);
    float16, used for visualisation volumes, is widened to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == np.float16 else x


class _Writer:
    """One background thread draining a queue of save closures."""

    DROP_DEPTH = 8
    dropped = 0

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def _ensure(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="artifact-writer", daemon=True)
                self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except Exception:  # never kill the writer on one bad artifact
                _log.exception("artifact save failed")
            finally:
                self._q.task_done()

    def submit(self, fn, droppable: bool = False):
        self._ensure()
        # purely visual work is skipped (counted) once the backlog is deep,
        # so queued closures cannot pin device memory without bound;
        # checkpoints, samples and metrics always queue
        if droppable and self._q.qsize() >= self.DROP_DEPTH:
            self.dropped += 1
            if self.dropped in (1, 10, 100):
                _log.warning(
                    "artifact-writer backlog >= %d: dropped %d droppable "
                    "figure submission(s) to avoid pinning device memory",
                    self.DROP_DEPTH, self.dropped)
            return
        self._q.put(fn)

    def flush(self):
        """Block until every queued save has been written."""
        self._q.join()


_WRITER = _Writer()


def submit(fn, droppable: bool = False) -> None:
    """Queue ``fn()`` on the background artifact-writer thread;
    ``droppable=True`` marks best-effort visual work (figures)."""
    _WRITER.submit(fn, droppable=droppable)


def flush() -> None:
    """Wait for all queued artifact writes (phase boundaries, test exits)."""
    _WRITER.flush()


def _im_path(save_dirs, name):
    return Path(save_dirs["images"]) / f"{name}.nii.gz"


def save_fixed_im(save_dirs, spacing, im):
    write_nifti(_im_path(save_dirs, "im_fixed"), _np(im).squeeze(), spacing)


def save_moving_im(save_dirs, spacing, im):
    write_nifti(_im_path(save_dirs, "im_moving"), _np(im).squeeze(), spacing)


def save_fixed_mask(save_dirs, spacing, mask):
    write_nifti(_im_path(save_dirs, "mask_fixed"), _np(mask).squeeze().astype(np.uint8), spacing)


def save_moving_mask(save_dirs, spacing, mask):
    write_nifti(_im_path(save_dirs, "mask_moving"), _np(mask).squeeze().astype(np.uint8), spacing)


def save_sample(save_dirs, spacing, sample_no, im_warped, displacement, log_det_J, model: str,
                chain_no=None):
    """Per-sample dump: warped image, displacement field, log|J| map.
    ``model`` is ``'VI'`` or ``'MCMC'``; MCMC samples carry a chain prefix."""
    samples_dir = Path(save_dirs["samples"]) / model
    samples_dir.mkdir(parents=True, exist_ok=True)
    prefix = f"chain_{chain_no}_" if chain_no is not None else ""
    name = f"{prefix}sample_{int(sample_no):07d}"

    im = _np(im_warped)
    disp = _np(displacement)
    ldj = _np(log_det_J)
    if chain_no is not None and im.ndim == 4:
        im, disp, ldj = im[chain_no], disp[chain_no], ldj[chain_no]

    write_nifti(samples_dir / f"{name}_im_warped.nii.gz", im.squeeze(), spacing)
    write_nifti(samples_dir / f"{name}_log_det_J.nii.gz", np.nan_to_num(ldj).squeeze(), spacing)
    write_vtk_field(samples_dir / f"{name}_displacement.vtk", disp, spacing)


def save_variational_posterior_mean(save_dirs, spacing, im_warped, displacement):
    write_nifti(_im_path(save_dirs, "im_moving_warped_mu_v"), _np(im_warped).squeeze(), spacing)
    write_vtk_field(Path(save_dirs["fields"]) / "displacement_mu_v.vtk",
                    _np(displacement).squeeze(), spacing)


def save_displacement_mean_and_std_dev(save_dirs, spacing, mean, std_dev, mask, model: str):
    """Posterior mean + per-voxel std-dev maps, masked and unmasked."""
    fields = Path(save_dirs["fields"])
    mean = _np(mean)
    std = _np(std_dev)
    m = _np(mask).squeeze().astype(bool)

    write_vtk_field(fields / f"{model}_displacement_mean.vtk", mean, spacing)
    write_vtk_field(fields / f"{model}_displacement_std_dev.vtk", std, spacing)
    write_vtk_field(fields / f"{model}_displacement_mean_masked.vtk", mean * m, spacing)
    write_vtk_field(fields / f"{model}_displacement_std_dev_masked.vtk", std * m, spacing)

    # scalar uncertainty magnitude as NIfTI for viewers
    write_nifti(fields / f"{model}_uncertainty_norm.nii.gz", np.linalg.norm(std, axis=0), spacing)
