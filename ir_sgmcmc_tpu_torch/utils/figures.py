"""Matplotlib figure builders for experiment tracking (port of
``ir_sgmcmc_tpu/utils/figures.py``).

Residual histogram with the fitted GMM pdf overlay, mid-slice image grids
(axial / coronal / sagittal), field-norm grids for the variational
parameters and displacement, and per-chain sample grids.  Figures are
returned (not shown) so the trainer can push them to the ScalarWriter.

matplotlib is imported only inside the builders (Agg backend); the
trainer calls them only when the writer records figures, so the default
path never imports it.  Everything here takes numpy arrays.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _mid_slices(vol: np.ndarray):
    """(axial, coronal, sagittal) mid-slices of an (X, Y, Z) volume."""
    x, y, z = (s // 2 for s in vol.shape[-3:])
    return vol[..., :, :, z], vol[..., :, y, :], vol[..., x, :, :]


def residual_histogram(residuals: np.ndarray, mask: np.ndarray,
                       log_proportions: np.ndarray, log_scales: np.ndarray,
                       bins: int = 100):
    """Histogram of masked residuals + the GMM mixture pdf overlay.

    Reference: the reference's logger/visualization.py:63-86 (``log_hist_res``).
    """
    plt = _plt()
    res = np.asarray(residuals)[np.asarray(mask, bool)].ravel()
    props = np.exp(np.asarray(log_proportions, np.float64))
    scales = np.exp(np.asarray(log_scales, np.float64))

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(res, bins=bins, density=True, alpha=0.5, label="residuals")
    lo, hi = np.percentile(res, [0.5, 99.5])
    xs = np.linspace(lo, hi, 512)
    pdf = np.zeros_like(xs)
    for p, s in zip(props, scales):
        pdf += p * np.exp(-0.5 * (xs / s) ** 2) / (s * np.sqrt(2 * np.pi))
    ax.plot(xs, pdf, "r-", lw=1.5, label="GMM pdf")
    ax.set_xlim(lo, hi)
    ax.legend()
    ax.set_title("LCC residuals vs fitted GMM")
    fig.tight_layout()
    return fig


def image_grid(vols: dict, masked: bool = False):
    """Rows = axial/coronal/sagittal mid-slices, columns = named volumes.

    Reference: the reference's logger/visualization.py:94-146 (``log_images``).
    """
    plt = _plt()
    names = list(vols)
    fig, axes = plt.subplots(3, len(names), figsize=(3 * len(names), 9),
                             squeeze=False)
    for j, name in enumerate(names):
        sls = _mid_slices(np.asarray(vols[name]).squeeze())
        for i, sl in enumerate(sls):
            axes[i][j].imshow(np.rot90(sl), cmap="gray")
            axes[i][j].axis("off")
            if i == 0:
                axes[i][j].set_title(name, fontsize=9)
    fig.tight_layout()
    return fig


def field_norm_grid(fields: dict):
    """Voxel-wise L2-norm mid-slices of named (3, X, Y, Z) fields.

    Reference: the reference's logger/visualization.py:154-204 (``log_fields``).
    """
    plt = _plt()
    names = list(fields)
    fig, axes = plt.subplots(3, len(names), figsize=(3 * len(names), 9),
                             squeeze=False)
    for j, name in enumerate(names):
        norm = np.linalg.norm(np.asarray(fields[name]), axis=0)
        for i, sl in enumerate(_mid_slices(norm)):
            im = axes[i][j].imshow(np.rot90(sl), cmap="viridis")
            axes[i][j].axis("off")
            if i == 0:
                axes[i][j].set_title(name, fontsize=9)
        fig.colorbar(im, ax=axes[:, j], shrink=0.6)
    return fig


def sample_grid(im_warped: np.ndarray, displacement: np.ndarray,
                log_det_J: np.ndarray, chain_no=None):
    """One posterior sample: warped image, |displacement|, log|J| mid-slices.

    Reference: the reference's logger/visualization.py:212-258 (``log_sample``).
    """
    plt = _plt()
    cols = {
        "im_warped": (np.asarray(im_warped).squeeze(), "gray"),
        "|displacement|": (np.linalg.norm(np.asarray(displacement), axis=0), "viridis"),
        "log|J|": (np.nan_to_num(np.asarray(log_det_J)).squeeze(), "coolwarm"),
    }
    fig, axes = plt.subplots(3, 3, figsize=(9, 9), squeeze=False)
    for j, (name, (vol, cmap)) in enumerate(cols.items()):
        for i, sl in enumerate(_mid_slices(vol)):
            axes[i][j].imshow(np.rot90(sl), cmap=cmap)
            axes[i][j].axis("off")
            if i == 0:
                title = name if chain_no is None else f"{name} (chain {chain_no})"
                axes[i][j].set_title(title, fontsize=9)
    fig.tight_layout()
    return fig


def mean_std_grid(mean: np.ndarray, std: np.ndarray):
    """Posterior displacement mean-norm and std-norm mid-slices.

    Reference: the reference's logger/visualization.py:261-296.
    """
    return field_norm_grid({"mean(displacement)": mean, "std(displacement)": std})
