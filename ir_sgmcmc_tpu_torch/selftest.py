"""GPU selftest: every hand-written kernel against its plain PyTorch version
on the card.

    python -m ir_sgmcmc_tpu_torch.selftest

Builds the kernel library from ``csrc/`` (nvcc, sm_90a) and holds each
kernel of ``kernels.all_kernels()``, in each of its variants, to its plain
version on the same inputs on the card, at the tolerances of ``TOL``:

* every family at the two small shapes ``(3, 8, 8, 128)`` (one 128-wide
  row) and ``(3, 16, 16, 256)`` (two): B1/B2 on 3 channels in f32 and in
  bf16, B5-B7 at R 2
  and the chain-batched B5 (a batch of 2), and B3/B4 through the public
  ``warp_block_gather`` with autograd (bound 5, R 2, block 8) against the
  same op on the CPU, where it takes the plain versions;
* the shapes the main paths give the kernels and ragged ones around their
  tiles (``SPLIT_SHAPES``, ``BLOCK_SHAPES``, ``BOUNDED_SHAPES``,
  ``ZHALO_SHAPES``, which ``chip_smoke.py`` times): B1/B2 in f32 and in
  bf16 (the saturated z-slab too), B3/B4 at R 1-3 in their
  window kernels, B5-B7 at R 1-3, the z-halo modes of B5/B6 and the
  z-pad mode of B7 at R 1, 2, 4, the z-halo modes of B1/B2
  (``SPLIT_ZHALO_SHAPES``) and of B3/B4 (``BLOCK_ZHALO_SHAPES``, window
  and per-voxel kernels), the Taylor squaring T1/T2 (``TAYLOR_SHAPES``:
  T1 to the bit) and the residual map L1/L2 (``LCN_SHAPES``: L1 to the
  bit, L2 against autograd's VJP);
* the per-voxel kernels the window and ring kernels leave to other
  shapes: B3/B4 at block 4 and at R 4, B5-B7 at R 4.

It prints one JSON line ``{"ok", "platform": "gpu", "kind", "checks":
{name: max_abs_err}, "total_s"}`` and exits 0 only if every check passes.
Without a card it prints ``ok: false`` with the reason and exits 2: it
never runs the plain versions in the kernels' place.

The operand builders and shape tables here are the one list of what a
kernel is held to: ``chip_smoke.py`` phase 2 draws its operands from them.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import torch

CHAINS = 2
MAIN = (128, 128, 128)  # the main paths' volume
SMALL = (64, 64, 64)
SVFFD_RADIUS = 3  # the block radius of the SVFFD model at 128³ (configs/README.md)
SELFTEST_SHAPES = ((8, 8, 128), (16, 16, 256))

# atol, rtol of each kernel against its plain version.  B1/B3/B5-B7: the
# same taps in another order; B2/B4 sum products of up to 8 taps' slopes
# and cotangents, B4 over C channels; B5-B7 add rtol for the sums of up to
# 27·C products at C = 4.  The bf16 modes of B1/B2 and their plain versions
# each compute in f32 and round once to bf16: the f32 atol plus one bf16
# ulp (2^-7 of |x|, 8e-3 with the rounding of |x| itself).
TOL = {"split_warp_fwd": (2e-5, 0.0), "split_warp_bwd": (3e-5, 1e-4),
       "split_warp_fwd_bf16": (2e-5, 8e-3), "split_warp_bwd_bf16": (3e-5, 8e-3),
       "block_warp_fwd": (1e-5, 0.0), "block_warp_dgrad": (5e-4, 1e-4),
       "warp_bounded_fwd": (1e-5, 1e-5), "warp_bounded_dgrad": (1e-5, 1e-5),
       "warp_bounded_tblend": (1e-5, 1e-5), "warp_bounded_fwd_zhalo": (1e-5, 1e-5),
       "warp_bounded_dgrad_zhalo": (1e-5, 1e-5), "warp_bounded_tblend_zpad": (1e-5, 1e-5)}
# the z-halo modes of B1-B4 (and the bf16 ones of B1/B2): their default
# modes' sums, read at an offset
TOL.update({"split_warp_fwd_zhalo": TOL["split_warp_fwd"],
            "split_warp_bwd_zhalo": TOL["split_warp_bwd"],
            "split_warp_fwd_zhalo_bf16": TOL["split_warp_fwd_bf16"],
            "split_warp_bwd_zhalo_bf16": TOL["split_warp_bwd_bf16"],
            "block_warp_fwd_zhalo": TOL["block_warp_fwd"],
            "block_warp_dgrad_zhalo": TOL["block_warp_dgrad"]})
# T1 rounds each operation as the plain forward does, in its order: equal to
# the bit.  T2 sums the plain VJP's terms in its order too, but the plain
# version's channel sum is torch's reduction, whose order is torch's.
TOL.update({"taylor_square_fwd": (0.0, 0.0), "taylor_square_bwd": (1e-5, 1e-6)})
# L1 rounds as the plain forward does, in its order: equal to the bit.  L2
# follows autograd's order of adds; held to autograd's VJP within 1e-6 of the
# gradient's largest element (its flat regions' 1/s reaches 1e5), scaled per
# check, so this entry is the share of that element
TOL.update({"lcn_residual_fwd": (0.0, 0.0), "lcn_residual_bwd": (1e-6, 0.0)})

# (shape, slab, offset) of B1/B2: the main path's, a tiny one, one that
# straddles the tiles and 16-plane z-chunks with u saturated in a z-slab,
# then for the bf16 kernels' staging paths: W 40 (W % 8 == 0, a 64-wide
# tile across the x border), W 64 (16-byte copies everywhere) and operands
# at storage offset 1, not 16-byte aligned (2-byte loads)
SPLIT_SHAPES = (((CHAINS, 3) + MAIN, None, 0), ((1, 3, 2, 9, 33), None, 0),
                ((2, 3, 40, 24, 130), (14, 19), 0), ((2, 3, 16, 24, 40), None, 0),
                ((2, 3, 16, 24, 64), None, 0), ((1, 3, 17, 10, 64), None, 1))

# (shape, bound, radius) of the block warp: the dense path's (bound 9, R 2,
# block 8), ragged shapes whose dims divide by 8 but are neither cubes nor
# multiples of the window kernels' 32-wide tile, and the SVFFD path's
# (bound 9, R 3); all four take B3's and B4's window kernels
# (fwd_window_kernel<R, false>, dgrad_window_kernel<R, false>)
BLOCK_SHAPES = (((CHAINS, 1) + MAIN, 9, 2), ((1, 4, 16, 24, 136), 6, 1), ((2, 2, 24, 8, 40), 9, 2),
                ((CHAINS, 1) + MAIN, 9, SVFFD_RADIUS))
# (shape, bound, radius, block) that take B3's and B4's per-voxel kernels
BLOCK_VOXEL_SHAPES = (((2, 2, 12, 8, 20), 5, 2, 4), ((2, 1, 16, 16, 48), 9, 4, 8))

# (shape, radius) of B5-B7: the VI path's, a general 4-channel one, two that
# straddle the tiles and z-chunks, dims of 1 and 2, and R 4 (per-voxel
# gathers, B7's run-time-R kernel)
BOUNDED_SHAPES = (((CHAINS, 1) + MAIN, 1), ((CHAINS, 4) + SMALL, 2), ((2, 1, 40, 24, 130), 1),
                  ((1, 2, 17, 10, 70), 2), ((1, 3, 2, 1, 9), 3), ((1, 2, 12, 10, 36), 4))

# (output shape, radius) of the z-halo modes, and g's shape for B7's z-pad
# mode; the vol (B7Z: the output) is 2R planes deeper: the ring (tiled)
# kernels at R 1 (timed) and at a ragged 4-channel R 2, the per-voxel (B7Z:
# run-time-R) kernels at R 4
ZHALO_SHAPES = (((CHAINS, 1) + MAIN, 1), ((1, 4, 17, 10, 70), 2), ((1, 2, 9, 12, 40), 4))

# output (slab) shapes of B1's and B2's z-halo modes (d_h and u_h one plane
# deeper on each side): a slab of 2 shards of the main path's volume, and a
# ragged one across the tiles and 16-plane z-chunks
SPLIT_ZHALO_SHAPES = ((CHAINS, 3, MAIN[0] // 2) + MAIN[1:], (2, 3, 17, 24, 130))

# (slab shape, bound, radius, block, h) of B3's and B4's z-halo modes (vol_h
# 2h planes deeper, h = bound + R + 1 as the sharded warp takes it): a slab
# of 2 shards of the dense path's volume (window kernels, R 2), a ragged
# 4-channel one at R 1 (window kernels), and R 4 (per-voxel kernels)
BLOCK_ZHALO_SHAPES = (((CHAINS, 1, MAIN[0] // 2) + MAIN[1:], 9, 2, 8, 12),
                      ((1, 4, 16, 24, 136), 6, 1, 8, 8), ((2, 1, 16, 16, 48), 9, 4, 8, 14))


# fields of the Taylor squaring T1/T2: the main paths' 2 chains and 8 chain
# rows (4 pairs x 2 chains), unbatched, ragged across the kernels' 32 x 8
# tiles and 32-plane chunks, each of D, H, W at 2, and two leading axes
TAYLOR_SHAPES = ((CHAINS, 3) + MAIN, (8, 3) + MAIN, (3, 7, 9, 10), (2, 3, 40, 35, 70),
                 (1, 3, 2, 17, 33), (1, 3, 33, 2, 65), (1, 3, 66, 3, 2), (2, 2, 3, 8, 8, 8))


# (moving shape, one shared fixed image, radius) of the residual map L1/L2:
# the pair cells' 8 rows at 128³ (a fixed image per row), the 256³ cells' 2
# rows (one shared image), unbatched, ragged across the 32 x 8 tiles and 8-
# and 4-plane chunks, dims of 2 and 1, and each at R 2
LCN_SHAPES = (((8,) + MAIN, False, 1), ((CHAINS, 256, 256, 256), True, 1), (MAIN, False, 1),
              ((2, 17, 10, 70), False, 1), ((3, 17, 10, 70), True, 2), ((1, 2, 9, 33), False, 1),
              ((2, 5, 2, 40), True, 2), ((2, 9, 12, 2), False, 2), ((1, 1, 7, 5), True, 1))


def lcn_operands(gen, shape, shared):
    """fixed, warped, g for L1/L2: unit-variance images with a flat slab (the
    phantoms' background: var 0, so 1/sqrt(var + 1e-10) is 1e5 there), the
    fixed image one ``(D, H, W)`` volume where ``shared``, and a unit
    cotangent."""
    dev = gen.device
    f = torch.randn(shape[-3:] if shared else shape, generator=gen, device=dev)
    w = torch.randn(shape, generator=gen, device=dev)
    slab = max(1, shape[-3] // 4)
    f[..., :slab, :, :] = 0.25
    w[..., :slab, :, :] = 0.5
    return f, w, torch.randn(shape, generator=gen, device=dev)


def taylor_operands(gen, shape):
    """d, g for T1/T2: a displacement of a few tenths of a voxel, as the
    squarings see it, and a unit cotangent."""
    d = torch.randn(shape, generator=gen, device=gen.device) * 0.7
    return d, torch.randn(shape, generator=gen, device=gen.device)


def split_operands(gen, shape, slab=None, dtype=torch.float32, offset=0):
    """d, u, g for B1/B2; no exact ties at u = 0 or |u| = 1, where autograd
    of the plain step and the kernel take different (equally valid)
    subgradients.  ``slab``: z-planes where u is saturated beyond ±1.
    ``dtype`` bf16 rounds the three, which puts some u at ±1 exactly: there
    the bf16 kernel and its plain version both take no offset gradient.
    ``offset``: each is a contiguous view at that storage offset (in
    elements) of a larger buffer."""
    dev = gen.device
    d = torch.randn(shape, generator=gen, device=dev) * 2.0
    u = torch.randn(shape, generator=gen, device=dev) * 0.9
    u = torch.where(u.abs() == 1, u * 1.001, u)
    u = torch.where(u == 0, torch.full_like(u, 1e-3), u)
    if slab is not None:
        z = slice(*slab)
        u[:, :, z] = torch.where(u[:, :, z] < 0, -1.5, 1.5) + u[:, :, z]
    g = torch.randn(shape, generator=gen, device=dev)
    return tuple(_at_offset(t.to(dtype), offset) for t in (d, u, g))


def _at_offset(t, offset: int):
    """``t`` copied into a contiguous view at storage offset ``offset``."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def block_operands(gen, shape, bound, radius, saturate=False, block=8):
    """vol, r, m, g for B3/B4: a smooth displacement (trilinear upsampling
    of a coarse random field), its block means and clipped residual, every
    7th residual an integer.  ``saturate``: the blocks next to the z and x
    borders get means of ±bound, whose windows clamp at the border; the
    field gets in-block roughness, and every 11th residual is exactly +R,
    every 13th -R."""
    from .kernels import block_warp as bw
    from .ops.resample import _block_means

    dev = gen.device
    B, C, D, H, W = shape
    vol = torch.randn(shape, generator=gen, device=dev)
    coarse = torch.randn((B, 3, 3, 3, 3), generator=gen, device=dev) * (bound - 1.0)
    disp = torch.nn.functional.interpolate(coarse, size=(D, H, W), mode="trilinear",
                                           align_corners=True)
    disp = disp.clamp(-(bound - 0.5), bound - 0.5)
    if saturate:
        disp[:, :, :block] = bound + 0.4
        disp[:, :, -block:] = -bound - 0.4
        disp[..., -block:] = torch.where(disp[..., -block:] < 0, -bound - 0.4, bound + 0.4)
        disp += torch.randn(disp.shape, generator=gen, device=dev) * 0.8
    m = _block_means(disp, block, bound)
    r = (disp - bw._expand_blocks(m, block).float()).clamp(-radius, radius)
    flat = r.view(-1)
    flat[::7] = torch.round(flat[::7])
    if saturate:
        flat[1::11] = radius
        flat[2::13] = -radius
    return vol, r.contiguous(), m, torch.randn(shape, generator=gen, device=dev)


def split_zhalo_operands(gen, shape, dtype=torch.float32):
    """d_h, u_h (one plane deeper on each side than ``shape``) and g for
    B1Z/B2Z (``dtype`` bf16: B1Z-bf16/B2Z-bf16), drawn as
    :func:`split_operands` draws them."""
    B, C, D, H, W = shape
    d_h, u_h, _ = split_operands(gen, (B, C, D + 2, H, W), dtype=dtype)
    return d_h, u_h, torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def block_zhalo_operands(gen, shape, bound, radius, block, h):
    """vol_h (``2h`` planes deeper than ``shape``), r, m, g for B3Z/B4Z: the
    slab's operands as :func:`block_operands` draws them, with block means
    at ±bound next to its z ends (the taps reach into the window's halo)."""
    B, C, D, H, W = shape
    _, r, m, g = block_operands(gen, shape, bound, radius, saturate=True, block=block)
    vol_h = torch.randn((B, C, D + 2 * h, H, W), generator=gen, device=gen.device)
    return vol_h, r, m, g


def bounded_operands(gen, shape, R):
    """vol, disp, g for the bounded warp: ``disp`` uniform in ±1.4R with
    every 7th value an integer, every 11th exactly +R and every 13th -R."""
    dev = gen.device
    B, C = shape[:2]
    vol = torch.randn(shape, generator=gen, device=dev)
    disp = (torch.rand((B, 3) + shape[2:], generator=gen, device=dev) * 2 - 1) * (1.4 * R)
    flat = disp.view(-1)
    flat[::7] = torch.round(flat[::7])
    flat[1::11] = float(R)
    flat[2::13] = -float(R)
    return vol, disp, torch.randn(shape, generator=gen, device=dev)


def zhalo_grid(disp, R: int):
    """``grid_sample``'s normalised points in a z-haloed vol ``(D + 2R, H,
    W)`` at identity + ``clip(disp, ±R)``, z shifted by the halo."""
    B, _, D, H, W = disp.shape
    d = disp.clamp(-R, R)
    z, y, x = torch.meshgrid(*(torch.arange(n, device=disp.device, dtype=torch.float32)
                               for n in (D, H, W)), indexing="ij")
    return torch.stack([(x + d[:, 0]) * (2.0 / (W - 1)) - 1.0,
                        (y + d[:, 1]) * (2.0 / (H - 1)) - 1.0,
                        (z + R + d[:, 2]) * (2.0 / (D + 2 * R - 1)) - 1.0], dim=-1)


def _smooth_disp(gen, shape, magnitude):
    """A smooth ``(1, 3, D, H, W)`` field in ``±magnitude``: a random 2³
    field upsampled trilinearly (the JAX selftest resizes it cubically),
    clipped."""
    c = torch.randn((1, 3, 2, 2, 2), generator=gen, device=gen.device) * magnitude
    d = torch.nn.functional.interpolate(c, size=shape, mode="trilinear", align_corners=False)
    return d.clamp(-magnitude, magnitude).contiguous()


class _Checks:
    """Max abs error of each check, and whether all passed their
    ``|out - ref| <= atol + rtol·|ref|``."""

    def __init__(self, log):
        self.errs: dict[str, float] = {}
        self.ok = True
        self.log = log

    def __call__(self, name: str, out, ref, tol) -> float:
        atol, rtol = tol
        out, ref = out.float(), ref.to(out.device).float()
        diff = (out - ref).abs()
        good = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
        err = float(diff.max()) if diff.numel() else 0.0
        self.errs[name] = err
        self.ok &= good
        if self.log:
            status = "ok" if good else f"FAIL (atol {atol:g}, rtol {rtol:g})"
            print(f"  {name:56s} max|err| = {err:.3e}  {status}", file=sys.stderr, flush=True)
        return err


def _families(dev, gen, shape, check) -> None:
    """The JAX selftest's three families at one small shape."""
    from .kernels import warp_bounded as wb

    tag = "x".join(map(str, shape))
    R = 2
    vol, disp, g = bounded_operands(gen, (1, 3) + shape, R)
    check(f"warp_bounded_fwd@{tag}", wb.warp_bounded_fwd_cuda(vol, disp, R),
          wb.warp_bounded_plain(vol, disp, R), TOL["warp_bounded_fwd"])
    check(f"warp_bounded_dgrad@{tag}", wb.warp_bounded_dgrad_cuda(vol, disp, g, R),
          wb.warp_bounded_dgrad_plain(vol, disp, g, R), TOL["warp_bounded_dgrad"])
    check(f"warp_bounded_tblend@{tag}", wb.warp_bounded_tblend_cuda(disp, g, R),
          wb.warp_bounded_tblend_plain(disp, g, R), TOL["warp_bounded_tblend"])
    vol2, disp2 = torch.cat([vol, vol * 0.5]), torch.cat([disp, -disp])
    check(f"warp_bounded_fwd.batch2@{tag}", wb.warp_bounded_fwd_cuda(vol2, disp2, R),
          torch.cat([wb.warp_bounded_plain(vol2[b:b + 1], disp2[b:b + 1], R) for b in range(2)]),
          TOL["warp_bounded_fwd"])

    for dtype in (torch.float32, torch.bfloat16):
        _split_checks(check, split_operands(gen, (1, 3) + shape, dtype=dtype), f"@{tag}")

    # the public block-gather warp with autograd, against the same op on
    # the CPU (the plain versions)
    bound = 5
    vol1 = torch.randn((1, 1) + shape, generator=gen, device=dev)
    disp1 = _smooth_disp(gen, shape, 4.0) + 0.25
    (y_k, g_k), (y_p, g_p) = (_block_gather_grad(vol1.to(where), disp1.to(where), bound, R)
                              for where in (dev, torch.device("cpu")))
    check(f"block_warp_fwd.public@{tag}", y_k, y_p, TOL["block_warp_fwd"])
    check(f"block_warp_dgrad.public_grad@{tag}", g_k, g_p, TOL["block_warp_dgrad"])


def _split_checks(check, operands, tag: str) -> None:
    """B1 and B2 (or their bf16 modes, by the operands' dtype) against their
    plain versions: f32 ``ū`` with the ``+g`` of the direct term, bf16
    ``ū_warp`` as B2-bf16 returns it."""
    from .kernels import split_warp as sw

    d, u, g = operands
    sfx = "_bf16" if d.dtype == torch.bfloat16 else ""
    fwd, bwd = f"split_warp_fwd{sfx}", f"split_warp_bwd{sfx}"
    check(f"{fwd}{tag}", sw.split_warp_fwd_cuda(d, u), sw.split_compose_plain(d, u), TOL[fwd])
    gd_k, gu_k = sw.split_warp_bwd_cuda(d, u, g)
    if sfx:
        gd_p, gu_p = sw.split_warp_vjp_plain(d, u, g)
    else:
        gd_p, gu_p = sw.split_compose_vjp_plain(d, u, g)
        gu_k = gu_k + g
    check(f"{bwd}.d{tag}", gd_k, gd_p, TOL[bwd])
    check(f"{bwd}.u{tag}", gu_k, gu_p, TOL[bwd])


def _block_gather_grad(vol, disp, bound, R):
    """``warp_block_gather`` (block 8) and the gradient of its sum of
    squares with respect to ``disp``."""
    from .ops.resample import warp_block_gather

    x = disp.requires_grad_(True)
    y = warp_block_gather(vol, x, bound, R, 8)
    (grad,) = torch.autograd.grad(y.pow(2).sum(), x)
    return y.detach(), grad


def run_selftest(dev=None, log: bool = True) -> dict:
    """Every check on the card ``dev`` (default ``cuda:0``); returns
    ``{"ok", "checks"}``.  The kernels' launch counters move."""
    from .kernels import block_warp as bw
    from .kernels import lcn_residual as lr
    from .kernels import split_warp as sw
    from .kernels import taylor_square as ts
    from .kernels import warp_bounded as wb
    from .ops.stencil import _taylor_squaring_impl, _taylor_squaring_vjp_impl

    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    if dev.type != "cuda":
        raise ValueError(f"the selftest runs on a CUDA card, got {dev}")
    gen = torch.Generator(device=dev).manual_seed(2024)
    check = _Checks(log)
    for shape in SELFTEST_SHAPES:
        _families(dev, gen, shape, check)

    for (shape, slab, offset), dtype in itertools.product(SPLIT_SHAPES,
                                                          (torch.float32, torch.bfloat16)):
        _split_checks(check, split_operands(gen, shape, slab, dtype, offset),
                      f"{tuple(shape)}" + (f" offset {offset}" if offset else ""))

    blocks = [(s, b, r, 8, s[2:] != MAIN) for s, b, r in BLOCK_SHAPES]
    blocks += [(s, b, r, k, True) for s, b, r, k in BLOCK_VOXEL_SHAPES]
    for shape, bound, R, block, saturate in blocks:
        vol, r, m, g = block_operands(gen, shape, bound, R, saturate, block)
        tag = f"{tuple(shape)} bound {bound} R {R} block {block}"
        check(f"block_warp_fwd{tag}", bw.block_warp_cuda(vol, r, m, R, block),
              bw.block_warp_plain(vol, r, m, block), TOL["block_warp_fwd"])
        check(f"block_warp_dgrad{tag}", bw.block_warp_dgrad_cuda(vol, r, m, g, R, block),
              bw.block_warp_dgrad_plain(vol, r, m, g, block), TOL["block_warp_dgrad"])

    for shape, R in BOUNDED_SHAPES:
        vol, disp, g = bounded_operands(gen, shape, R)
        tag = f"{tuple(shape)} R {R}"
        check(f"warp_bounded_fwd{tag}", wb.warp_bounded_fwd_cuda(vol, disp, R),
              wb.warp_bounded_plain(vol, disp, R), TOL["warp_bounded_fwd"])
        check(f"warp_bounded_dgrad{tag}", wb.warp_bounded_dgrad_cuda(vol, disp, g, R),
              wb.warp_bounded_dgrad_plain(vol, disp, g, R), TOL["warp_bounded_dgrad"])
        check(f"warp_bounded_tblend{tag}", wb.warp_bounded_tblend_cuda(disp, g, R),
              wb.warp_bounded_tblend_plain(disp, g, R), TOL["warp_bounded_tblend"])

    for shape, R in ZHALO_SHAPES:
        B, C, D, H, W = shape
        _, disp, g = bounded_operands(gen, shape, R)
        vol = torch.randn((B, C, D + 2 * R, H, W), generator=gen, device=dev)
        tag = f"{tuple(shape)} R {R}"
        check(f"warp_bounded_fwd_zhalo{tag}", wb.warp_bounded_fwd_cuda(vol, disp, R, z_halo=True),
              wb.warp_bounded_plain(vol, disp, R, z_halo=True), TOL["warp_bounded_fwd_zhalo"])
        check(f"warp_bounded_dgrad_zhalo{tag}",
              wb.warp_bounded_dgrad_cuda(vol, disp, g, R, z_halo=True),
              wb.warp_bounded_dgrad_plain(vol, disp, g, R, z_halo=True),
              TOL["warp_bounded_dgrad_zhalo"])
        check(f"warp_bounded_tblend_zpad{tag}", wb.warp_bounded_tblend_cuda(disp, g, R, z_pad=True),
              wb.warp_bounded_tblend_zpad_plain(disp, g, R), TOL["warp_bounded_tblend_zpad"])

    for (shape, dtype) in itertools.product(SPLIT_ZHALO_SHAPES, (torch.float32, torch.bfloat16)):
        d_h, u_h, g = split_zhalo_operands(gen, shape, dtype)
        tag, sfx = f"{tuple(shape)}", "_bf16" if dtype == torch.bfloat16 else ""
        fwd, bwd = f"split_warp_fwd_zhalo{sfx}", f"split_warp_bwd_zhalo{sfx}"
        check(f"{fwd}{tag}", sw.split_warp_fwd_zhalo_cuda(d_h, u_h),
              sw.split_compose_zhalo_plain(d_h, u_h), TOL[fwd])
        gd_k, gu_k = sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g)
        gd_p, gu_p = sw.split_warp_vjp_zhalo_plain(d_h, u_h, g)
        check(f"{bwd}.d{tag}", gd_k, gd_p, TOL[bwd])
        check(f"{bwd}.u{tag}", gu_k, gu_p, TOL[bwd])

    for shape, bound, R, block, h in BLOCK_ZHALO_SHAPES:
        vol_h, r, m, g = block_zhalo_operands(gen, shape, bound, R, block, h)
        tag = f"{tuple(shape)} bound {bound} R {R} block {block} h {h}"
        check(f"block_warp_fwd_zhalo{tag}", bw.block_warp_zhalo_cuda(vol_h, r, m, R, h, block),
              bw.block_warp_plain(vol_h, r, m, block, h), TOL["block_warp_fwd_zhalo"])
        check(f"block_warp_dgrad_zhalo{tag}",
              bw.block_warp_dgrad_zhalo_cuda(vol_h, r, m, g, R, h, block),
              bw.block_warp_dgrad_plain(vol_h, r, m, g, block, h), TOL["block_warp_dgrad_zhalo"])

    for shape in TAYLOR_SHAPES:
        d, g = taylor_operands(gen, shape)
        tag = f"{tuple(shape)}"
        check(f"taylor_square_fwd{tag}", ts.taylor_square_fwd_cuda(d), _taylor_squaring_impl(d),
              TOL["taylor_square_fwd"])
        check(f"taylor_square_bwd{tag}", ts.taylor_square_bwd_cuda(d, g),
              _taylor_squaring_vjp_impl(d, g), TOL["taylor_square_bwd"])

    for shape, shared, R in LCN_SHAPES:
        f, w, g = lcn_operands(gen, shape, shared)
        tag = f"{tuple(shape)}{' shared' if shared else ''} R {R}"
        res, dm, sd = lr.lcn_residual_fwd_cuda(f, w, R)
        check(f"lcn_residual_fwd{tag}", res, lr.lcn_residual_plain(f, w, R),
              TOL["lcn_residual_fwd"])
        x = w.clone().requires_grad_(True)
        (ref,) = torch.autograd.grad(lr.lcn_residual_plain(f, x, R), x, g)
        atol = TOL["lcn_residual_bwd"][0] * float(ref.abs().max())
        check(f"lcn_residual_bwd{tag}", lr.lcn_residual_bwd_cuda(dm, sd, g, R), ref, (atol, 0.0))
    torch.cuda.synchronize(dev)
    return {"ok": bool(check.ok), "checks": {k: float(f"{v:.3e}") for k, v in check.errs.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "platform": "cpu",
                          "error": "torch.cuda.is_available() is False: the selftest holds "
                                   "the CUDA kernels to their plain versions on a card"}))
        return 2
    t0 = time.monotonic()
    result = run_selftest()
    out = {"ok": result["ok"], "platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "checks": result["checks"], "total_s": round(time.monotonic() - t0, 2)}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
