"""The least work of the hand-written kernels and of a whole step, counted
from shapes.  Frozen here so that a later change to the program cannot
move the yardstick.

* :func:`kernel_bound_ms`: the port's ``Kernel.bound_ms`` formulas (each
  input read once, each output written once, the operations of the
  kernel's formula), per launch at the main operand's shape ``(B, C, D,
  H, W)``, over the H100 SXM's published peaks; the z-halo modes B1Z-B4Z
  of the spatially sharded step add their halo planes' bytes
  (``kernels/_lib.py``'s ``Kernel.bytes``).
* :func:`step_work`: the operations and bytes one SG-MCMC transition or
  VI iteration needs, from the algorithm's stages and shapes alone, so
  that it bounds the step whatever kernels implement it.
"""

from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

_M = 12 / 8 ** 3  # B3/B4's block means: 3 int32 per 8³ voxels
# kind -> (bytes per voxel, flops per voxel) of the main operand at C channels
KERNELS = {
    "B1": (lambda C: 4 * (2 * C + 3), lambda C: 19 * C),
    "B2": (lambda C: 4 * (3 * C + 6), lambda C: 39 * C),
    "B1-bf16": (lambda C: 2 * (2 * C + 3), lambda C: 19 * C),
    "B2-bf16": (lambda C: 2 * (3 * C + 6), lambda C: 39 * C),
    "B3": (lambda C: 4 * (2 * C + 3) + _M, lambda C: 24 + 15 * C),
    "B4": (lambda C: 4 * (2 * C + 6) + _M, lambda C: 64 + 16 * C),
    "B5": (lambda C: 4 * (2 * C + 3), lambda C: 24 + 15 * C),
    "B6": (lambda C: 4 * (2 * C + 6), lambda C: 64 + 16 * C),
    "B7": (lambda C: 4 * (2 * C + 3), lambda C: 18 + 16 * C),
}
# the z-halo modes: the same work per output voxel (kernels/split_warp.py,
# kernels/block_warp.py), and per voxel of each of the 2 x radius halo
# planes these bytes: B1Z reads d and u there, B2Z reads them and writes
# both gradients, B3Z/B4Z read the volume's window
KERNELS.update({"B1Z": KERNELS["B1"], "B2Z": KERNELS["B2"], "B3Z": KERNELS["B3"],
                "B4Z": KERNELS["B4"]})
HALO_BYTES = {"B1Z": lambda C: 4 * (C + 3), "B2Z": lambda C: 8 * (C + 3),
              "B3Z": lambda C: 4 * C, "B4Z": lambda C: 4 * C}
# the kind a trace names (the z-halo kernels share their names) -> the
# z-halo mode a sharded step launches, and its halo planes per side (None:
# the block warp's window, ``launch_bound_ms``'s ``window``)
ZHALO = {"B1": ("B1Z", 1), "B2": ("B2Z", 1), "B3": ("B3Z", None), "B4": ("B4Z", None)}


def kernel_bound_ms(kind: str, shape, radius: int = 0) -> float:
    """The least time of one launch of ``kind`` at ``shape`` (a z-halo
    mode: and ``radius`` halo planes on each side): the larger of its bytes
    over the HBM bandwidth and its operations over the f32 rate."""
    B, C, D, H, W = shape
    n = B * D * H * W
    per_byte, per_flop = KERNELS[kind]
    halo = B * 2 * int(radius) * H * W * HALO_BYTES[kind](C) if kind in HALO_BYTES else 0
    return 1e3 * max((n * per_byte(C) + halo) / HBM_BYTES_PER_S, n * per_flop(C) / F32_FLOP_PER_S)


def launch_bound_ms(kind: str, shape, shards: int = 1, window: int = 0) -> float:
    """The least time of one launch of the kind a trace names at ``shape``:
    on a step cut over ``shards > 1`` cards, of its z-halo mode
    (:data:`ZHALO`; the block warp's reads ``window`` planes on each
    side)."""
    if shards > 1 and kind in ZHALO:
        zkind, planes = ZHALO[kind]
        return kernel_bound_ms(zkind, shape, window if planes is None else planes)
    return kernel_bound_ms(kind, shape)


def rows_per_launch(phase: str, pairs: int, chains: int, remat: bool) -> int:
    """The rows of the forward chain that one kernel launch takes: every
    chain of every pair (SG-MCMC), both antithetic samples of every pair
    (VI), or one row where VI runs its rows in turn under remat."""
    if phase == "mcmc":
        return pairs * chains
    return 1 if remat else 2 * pairs


def kernel_shapes(phase: str, rows: int, dims, shards: int = 1) -> dict:
    """The main operand of each hand-written kernel on the ``"post"``
    paths the cells run, at ``rows`` rows per launch
    (:func:`rows_per_launch`): the split compositions on the displacement
    ``(rows, 3, …)``, the block warp on the image ``(rows, 1, …)``; on a
    step cut along D over ``shards`` cards, each card's slab of ``D /
    shards`` planes (its halo planes are :func:`launch_bound_ms`'s)."""
    dims = (int(dims[0]) // shards,) + tuple(dims[1:])
    field = (rows, 3) + dims
    image = (rows, 1) + dims
    return {"B1": field, "B2": field, "B1-bf16": field, "B2-bf16": field,
            "B3": image, "B4": image}


def step_work(phase: str, cfg: dict, pairs: int, chains: int) -> tuple:
    """``(flops, bytes)`` that one step of ``pairs`` pairs needs at least.

    Operations per voxel and stage, forward: Sobolev smoothing, three
    separable passes of ``2s + 1`` taps on 3 channels; the B-spline spread
    of SVFFD, three separable contractions; each Taylor squaring 30 (per
    axis a difference, a product and a sum on 3 channels, and the
    doubling); each split composition 60 (B1's 19 per channel, and the
    added offset); the trilinear warp 43; the local contrast
    normalisation of the warped image 22; the mixture's log-density 36;
    the regulariser's energy 27 per field voxel.  The gradient of that
    differentiated chain counts twice its forward.  Beside it: virtual
    decimation 47, the mixture's Adam step 72 per voxel; SG-MCMC the
    Langevin step 18 per field voxel and the Welford update 21; VI the
    draw 15 and the entropy 24 per field voxel and sample, and Adam on
    q(v) 108 per field voxel.

    Bytes: the state read once and written once (SG-MCMC: ``v`` and the
    preconditioner read, ``v`` written, the Welford mean and M2 read and
    written; VI: q(v)'s three fields and their two Adam moments read and
    written) and both images and the mask read once.
    """
    dims = tuple(int(n) for n in cfg["data_loader"]["args"]["dims"])
    n = math.prod(dims)
    targs = cfg["transformation_module"]["args"]
    svffd = cfg["transformation_module"]["type"] in ("SVFFD_3D", "SVFFD3D")
    if svffd:
        cps = [int(c) for c in targs["cps"]]
        ctrl = tuple(int(math.ceil((s - 1) / c)) + 3 for s, c in zip(dims, cps))
    else:
        ctrl = dims
    nf = math.prod(ctrl)
    no_steps, max_disp = int(targs.get("no_steps", 12)), int(targs.get("max_disp", 8))
    e = max(0, math.ceil(math.log2(max_disp))) if max_disp > 1 else 0
    sob = cfg.get("Sobolev_grad", {})
    smooth = 3 * 3 * (2 * int(sob["s"]) + 1) * 2 * nf if sob.get("enabled") else 0
    spread = 0
    if svffd:
        (cd, ch, cw), (d, h, w) = ctrl, dims
        spread = 2 * 3 * (cd * d * ch * cw + d * ch * h * cw + d * h * cw * w)
    chain = spread + n * (30 * (no_steps - e) + 60 * (2 ** e - 1) + 43 + 22 + 36) + 27 * nf
    per_row = smooth + 3 * chain + n * (47 + 72)
    if phase == "mcmc":
        rows = pairs * chains
        flops = rows * (per_row + 18 * nf + 21 * n)
        moved = rows * (4 * 3 * nf * 3 + 4 * 3 * n * 4 + 9 * n)
    else:
        rows = 2 * pairs
        flops = rows * (per_row + (15 + 24) * nf) + pairs * 108 * nf
        moved = pairs * (2 * 9 * 4 * 3 * nf + 9 * n)
    return flops, moved


def least_step_s(phase: str, cfg: dict, pairs: int, chains: int, shards: int = 1) -> tuple:
    """The least time of one step and what bounds it (``"operations"`` or
    ``"bytes"``): over one card's peaks, or with the step cut over
    ``shards`` cards (virtual shards of one card count once), its work
    divided over their peaks."""
    flops, moved = step_work(phase, cfg, pairs, chains)
    by_ops, by_bytes = flops / (shards * F32_FLOP_PER_S), moved / (shards * HBM_BYTES_PER_S)
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
