"""The spatially sharded SG-MCMC and VI steps: the whole training step cut
along D over the ``'space'`` axis of a mesh (no JAX counterpart module: the
JAX package hands the step to GSPMD's partitioner with Pallas off,
``ir_sgmcmc_tpu/trainer.py:826-866`` and ``:1187-1211``).

The port has no partitioner, so the step is written over the slabs of one
row of the ``'space'`` axis as ONE Python function and one autograd graph,
with every branch of ``engine.vi.forward_sample`` for the dense ``SVF3D``:

* Sobolev smoothing (identity backward) by halo exchange;
* the integration (``SVF3D.integrate``) from the sharded ops of
  ``parallel/halo.py``: the Taylor squarings (in bfloat16 under
  ``compute_dtype: "bfloat16"``), the squarings above the threshold
  (``HaloWarp``, B5Z-B7Z), the ``"split"`` compositions (B1Z/B2Z, or
  B1Z-bf16/B2Z-bf16), the ``"warp"`` ones (``HaloWarp`` on 3 channels) or
  the ``"taylor"`` ones (``halo.taylor_compose_slabs``);
* the image warp, by :func:`image_path`: on ``"post"`` the block-gather
  warp on each slab's window of the moving image (B3Z/B4Z), or below 64³
  ``grid_sample`` of the whole image, which each shard holds; on ``"pre"``
  (or without a noise magnitude) the image slabs ride the compositions
  (1-channel ``HaloWarp``\\ s at ``u_ψ``, or the fused 4-channel ``[d | g]``
  carry of the ``"warp"`` form), then a ``HaloWarp`` by the noise at radius
  ``max(1, ceil(alpha))``; with ``use_gather`` the ``no_steps`` squarings
  sample the whole field, all-gathered onto each shard, at the slab's
  points, and the whole image is sampled at ``T + noise``; anchored
  (``"post"`` SG-MCMC with ``anchored``), the residual warp of each slab
  off the row's anchor (:func:`make_chain_anchor_slabs`: ``W0`` sampled
  from the whole image, which each shard holds, at the slab's points,
  ``Jinv`` and ``GW0`` by the sharded gradient), in the ``"blend"`` mode
  by ``HaloWarp`` at the anchor radius (B5Z/B6Z);
* the fold and saturation counts, the LCC residuals;
* the global scalars (GMM NLL, VD sums, reg energy, entropy sums) as
  per-slab partial sums added on the row's first device, where the scalar
  work runs: the GMM Adam steps, the hyperpriors, the reg-parameter Adam
  (the Fourier energy through an all-to-all of the slabs' spectra,
  ``halo.fourier_energy_slabs``);
* the elementwise updates (Langevin step, Welford, q(v) Adam) on each slab.

Noise is the unsharded draw, cut: each shard draws its chains' whole field
from the chains' generators (``engine.vi.key_generator``) on its own device
and keeps its slab, so a sharded run takes the unsharded run's draws on the
same device type.  Nothing in a step waits on a device.

Per-chain parameter sets only, as in the JAX trainer.  :func:`unported`
names what the JAX package shards and the port does not.
"""

from __future__ import annotations

import functools
import math

import torch

from ..engine.mcmc import WelfordState, _reg_terms, _sgld_weight, welford_update
from ..engine.vi import anchored_residual, block_warp_bound, block_warp_engages, key_generator
from ..models.entropy import (entropy_analytic_from_sums, entropy_analytic_sums,
                              entropy_sample_from_sums, entropy_sample_sums)
from ..models.gmm import GMM
from ..models.reg_loss import RegLossL2, RegLossLogNormal
from ..models.sampler import langevin_noise, sample_q_v, uniform_voxel_noise
from ..models.transformation import SVF3D
from ..ops.grids import _axis_scale_on, det_jacobian, identity_grid, inv_jacobian
from ..ops.resample import grid_sample, grid_sample_each
from ..ops.stencil import _fwd_diff_axis
from ..optim.adam_decay import apply_updates
from ..utils.spans import MCMC_STEP, VI_STEP, span
from .halo import (HaloWarp, SobolevSmoothSlabs, _exchange_halo_d, allgather_slabs, block_halo,
                   block_residual_overflow_slabs, box_filter3d_slabs, fourier_energy_slabs,
                   fwd_diff_d_slabs, lag1_sums_slabs, split_compose_slabs, sum_slabs,
                   taylor_compose_slabs, taylor_squaring_slabs, warp_block_gather_slabs)
from .mesh import Mesh, Sharded, _map, gather, halo_images_spatial, run_in_turns

ROADMAP_ITEM = "ROADMAP A, 'The spatially sharded steps'"


def unported(bundle) -> str | None:
    """Why the spatially sharded step does not take ``bundle``'s problem
    (None: it does).  It takes the dense ``SVF3D`` under every option."""
    tr = bundle.transformation
    if not isinstance(tr, SVF3D):
        return (f"the spatially sharded step takes the dense SVF3D, not "
                f"{type(tr).__name__}")
    return None


def image_path(bundle) -> str:
    """How ``engine.vi.forward_sample`` warps the moving image for
    ``bundle``: ``"gather"`` (``use_gather``: ``grid_sample`` at ``T +
    noise``), ``"block"`` (``"post"`` with a noise magnitude where the
    block-gather warp engages), ``"grid"`` (``"post"`` below it:
    ``grid_sample`` at ``T + noise``) or ``"cascade"`` (``"pre"``, or no
    noise magnitude: the image rides the compositions)."""
    if getattr(bundle.transformation, "use_gather", False):
        return "gather"
    if bundle.uniform_noise_alpha is not None and bundle.noise_scheme == "post":
        return "block" if block_warp_engages(bundle) else "grid"
    return "cascade"


def _noise_radius(bundle) -> int:
    """The ``"pre"`` scheme's noise warp radius: it covers the magnitude."""
    return max(1, math.ceil(float(bundle.uniform_noise_alpha)))


def _refuse(bundle) -> None:
    why = unported(bundle)
    if why is not None:
        raise NotImplementedError(f"{why} ({ROADMAP_ITEM})")


def _on(tree, device):
    """A tree's tensors on ``device`` (a no-op where they are)."""
    return _map(lambda x, host: x if host else x.to(device, non_blocking=True), tree)


class _Row:
    """One row of the ``'space'`` axis: its flat mesh indices, devices and
    each slab's first plane."""

    def __init__(self, mesh: Mesh, idx: list, depth: int):
        self.idx = list(idx)
        self.devices = [mesh.device_list[i] for i in self.idx]
        self.dev0 = self.devices[0]
        self.n = len(self.idx)
        self.dl = depth // self.n
        self.z0 = [k * self.dl for k in range(self.n)]

    def cut(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """Slab ``k`` of a whole field (along D), on its device."""
        return t.narrow(-3, self.z0[k], self.dl).to(self.devices[k])


@functools.lru_cache(maxsize=64)
def _identity_slab(dims: tuple, device: torch.device, z0: int, dl: int) -> torch.Tensor:
    """The normalised identity grid's planes ``[z0, z0 + dl)``, made once per
    device (its values are the whole grid's)."""
    return identity_grid(dims, device=device)[:, z0:z0 + dl].contiguous()


def _to_normalised(x: torch.Tensor, dims) -> torch.Tensor:
    """``ops.grids.voxel_to_normalised`` at the volume's ``dims`` (a slab's
    own shape would give the wrong z scale)."""
    return x * _axis_scale_on(tuple(dims), x.device, True)


def _to_voxel(x: torch.Tensor, dims) -> torch.Tensor:
    """``ops.grids.normalised_to_voxel`` at the volume's ``dims``."""
    return x * _axis_scale_on(tuple(dims), x.device, False)


def _lcn_slabs(gmm: GMM, ims: list) -> list:
    """``GMM.residual_map``'s local contrast normalisation of one row's
    slabs, its box filters by halo exchange."""
    mu = [b / gmm.window for b in box_filter3d_slabs(ims, gmm.radius)]
    var = [b / gmm.window for b in box_filter3d_slabs(
        [(im - m) ** 2 for im, m in zip(ims, mu)], gmm.radius)]
    return [(im - m) / torch.sqrt(v + 1e-10) for im, m, v in zip(ims, mu, var)]


def _gradient_slabs(xs: list, dims, normalised: bool = False) -> list:
    """``ops.stencil.gradient`` of one row's slabs of ``(…, 3, D, H, W)``:
    the x and y differences local, the z ones by :func:`fwd_diff_d_slabs`."""
    D, H, W = dims
    out = []
    for x, dz in zip(xs, fwd_diff_d_slabs(xs)):
        dx, dy = _fwd_diff_axis(x, -1), _fwd_diff_axis(x, -2)
        if normalised:
            dx, dy, dz = dx * ((W - 1) / 2.0), dy * ((H - 1) / 2.0), dz * ((D - 1) / 2.0)
        out.append(torch.stack([dx, dy, dz], dim=x.ndim - 3))
    return out


def _energy(bundle, vs: list) -> torch.Tensor:
    """``RegLoss.energy`` of a batch of slabs ``(B, 3, Dl, H, W)``, summed on
    the row's first device: ``Σ ||∇v||²``, ``Σ ‖|ω| v̂‖²`` (the Fourier
    operator) or ``Σ v²`` (the identity)."""
    diff_op = bundle.reg_loss.diff_op
    if diff_op == "Fourier1stDerivativeOperator":
        return fourier_energy_slabs(vs, bundle.dims)
    if diff_op == "GradientOperator":
        vs = _gradient_slabs(vs, bundle.dims)
    return sum_slabs([torch.sum(x * x, dim=tuple(range(1, x.ndim))) for x in vs])


class _Images:
    """One row's images, placed once per step builder: the fixed image's
    slabs, its LCN and the mask's slabs, and what each shard's image warp
    reads of the moving image (:func:`image_path`): a window of ``h``
    planes on each side of its slab (the block-gather warp), its slab (the
    cascade, whose ``HaloWarp``\\ s exchange the halos) or the whole image
    (``grid_sample``).  ``anchored``: the anchored residual warp (path
    ``"anchor"``), whose anchor samples the whole image."""

    def __init__(self, bundle, fixed: Sharded, moving: Sharded, row: _Row,
                 moving_whole: dict, anchored: bool = False):
        self.fixed = [fixed[i]["im"] for i in row.idx]
        self.mask = [fixed[i]["mask"] for i in row.idx]
        with torch.no_grad():
            self.lcn_fixed = _lcn_slabs(bundle.gmm, self.fixed)
        self.path = "anchor" if anchored else image_path(bundle)
        self.h = None
        if self.path == "block":
            self.h = block_halo(block_warp_bound(bundle), bundle.block_radius)
            placed = halo_images_spatial({"im": moving_whole["im"]}, fixed.mesh,
                                         int(bundle.dims[0]), self.h)
            self.moving = [placed[i]["im"] for i in row.idx]
        elif self.path == "cascade":
            self.moving = [moving[i]["im"] for i in row.idx]
        else:
            self.moving = [moving_whole["im"].to(dev) for dev in row.devices]


def _warp_slabs(vols: list, disps: list, radius: int = 1) -> list:
    """``ops.resample.warp_bounded`` of one row's slabs (``HaloWarp``)."""
    return list(HaloWarp.apply(radius, len(vols), *(v.contiguous() for v in vols),
                               *(d.contiguous() for d in disps)))


def _integrate_slabs(tr: SVF3D, vs: list, ims: list | None = None) -> tuple:
    """``SVF3D.integrate`` of one row's slabs of ``v (B, 3, Dl, H, W)``,
    with the image slabs ``ims`` ``(Dl, H, W)`` riding the compositions
    when given.  Returns the displacement's slabs (float32) and the warped
    image's ``(B, Dl, H, W)`` (None without ``ims``).  The dtype casts are
    ``SVF3D.integrate``'s: the reduced dtype after ``/2^N``, float32 before
    the squarings above the threshold, before the ``"warp"`` form and on
    output."""
    disp = [x / float(2 ** tr.no_steps) for x in vs]
    if tr.compute_dtype is not None:
        disp = [d.to(tr.compute_dtype) for d in disp]
    for _ in range(tr.no_taylor):
        disp = taylor_squaring_slabs(disp)
    if tr.no_squarings - tr.no_taylor:
        disp = [d.float() for d in disp]
        for _ in range(tr.no_squarings - tr.no_taylor):
            disp = [d + w for d, w in zip(disp, _warp_slabs(disp, disp))]
    if tr.composition_form == "warp":
        disp = [d.float() for d in disp]
    u_phi = [d.contiguous() for d in disp]
    N = tr.no_compositions
    if tr.composition_form == "split":
        u_h = [t.contiguous() for t in _exchange_halo_d(u_phi, 1)]

        def dstep(ds):
            return split_compose_slabs(ds, u_h)
    elif tr.composition_form == "taylor":
        def dstep(ds):
            return taylor_compose_slabs(ds, u_phi)
    else:
        def dstep(ds):
            return [u + w for u, w in zip(u_phi, _warp_slabs(ds, u_phi))]

    g = None
    if ims is None:
        for _ in range(N - 1):
            disp = dstep(disp)
    else:
        B = vs[0].shape[0]
        vols = [im.expand((B, 1) + tuple(im.shape)) for im in ims]
        if tr.composition_form in ("split", "taylor"):
            K = tr.no_image_compositions
            m = N // K
            u_psi = u_phi
            for _ in range(m - 1):
                u_psi = dstep(u_psi)
            disp = u_psi
            u_psi32 = [u.float() for u in u_psi]  # float32 blend warps
            g = _warp_slabs(vols, u_psi32)
            for _ in range(K - 1):
                for _ in range(m):
                    disp = dstep(disp)
                g = _warp_slabs(g, u_psi32)
        else:
            g = _warp_slabs(vols, u_phi)  # g_1 = im ∘ φ
            if N > 1:  # the fused 4-channel [d | g] carry
                u_phi_g = [torch.cat([u, torch.zeros_like(gi)], dim=1) for u, gi in zip(u_phi, g)]
                state = [torch.cat([u, gi], dim=1) for u, gi in zip(u_phi, g)]
                for _ in range(N - 1):
                    state = [w + a for w, a in zip(_warp_slabs(state, u_phi), u_phi_g)]
                disp, g = [x[:, :3] for x in state], [x[:, 3:] for x in state]
        g = [x[:, 0] for x in g]
    return [d.float() for d in disp], g


def _gather_slabs(tr: SVF3D, row: _Row, vs: list, dims) -> tuple:
    """``SVF3D._call_gather`` of one row's slabs: ``no_steps`` squarings
    ``d <- d + d(id + d)`` in normalised units, each sampling the whole
    field (:func:`~.halo.allgather_slabs`) at the slab's points.  Returns
    the transformation's and the displacement's (voxels) slabs."""
    ids = [_identity_slab(dims, v.device, z0, row.dl) for v, z0 in zip(vs, row.z0)]
    disp = [_to_normalised(v, dims) / float(2 ** tr.no_steps) for v in vs]
    for _ in range(tr.no_steps):
        disp = [d + grid_sample_each(w, i + d)
                for d, w, i in zip(disp, allgather_slabs(disp), ids)]
    return [i + d for i, d in zip(ids, disp)], [_to_voxel(d, dims) for d in disp]


def make_chain_anchor_slabs(bundle, images: _Images, row: _Row, anchor_mode: str):
    """``anchor(shards) -> list``: ``engine.mcmc.make_chain_anchor`` over one
    row's shards (its chains' ``v`` slabs), with no gradient: each slab's
    anchor, ``W0`` sampled from the whole moving image, which each shard
    holds, at the slab's points of ``T0`` (``grid_sample``, the gather
    path's global sample), ``Jinv`` and ``GW0`` by the sharded gradient."""
    tr, dims = bundle.transformation, tuple(bundle.dims)

    def anchor(shards: list) -> list:
        with torch.no_grad():
            vs = [s.v for s in shards]
            if bundle._sobolev_kernel is not None:
                ks = [bundle.sobolev_kernel_on(dev) for dev in row.devices]
                vs = list(SobolevSmoothSlabs.apply(row.n, *ks, *vs))
            d0, _ = _integrate_slabs(tr, vs)
            w0 = [grid_sample(m, _identity_slab(dims, d.device, z0, row.dl)
                              + _to_normalised(d, dims))
                  for m, d, z0 in zip(images.moving, d0, row.z0)]
            out = [{"W0": w, "d0": d,
                    "Jinv": torch.clamp(inv_jacobian(_eye3(d) + j), -3.0, 3.0)}
                   for w, d, j in zip(w0, d0, _gradient_slabs(d0, dims))]
            if anchor_mode == "taylor":
                for a, g in zip(out, _gradient_slabs([w.unsqueeze(-4) for w in w0], dims)):
                    a["GW0"] = g[:, 0]
        return out

    return anchor


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).reshape(3, 3, 1, 1, 1)


def _anchored_warp_slabs(disp: list, unifs: list | None, anchors: list, radius: int) -> tuple:
    """``engine.vi.forward_sample``'s anchored residual warp of one row's
    slabs off their anchors: the warped image's slabs and the residual-clamp
    count (summed on the row's first device)."""
    R = int(radius)
    res = [anchored_residual(d, None if unifs is None else unifs[k], a, R)
           for k, (d, a) in enumerate(zip(disp, anchors))]
    deltas = [d for d, _ in res]
    if "GW0" in anchors[0]:
        warped = [a["W0"] + torch.sum(a["GW0"] * d, dim=-4) for a, d in zip(anchors, deltas)]
    else:
        warped = [w[:, 0] for w in _warp_slabs([a["W0"].unsqueeze(-4) for a in anchors],
                                               deltas, R)]
    return warped, sum_slabs([n for _, n in res])


def forward_slabs(bundle, images: _Images, row: _Row, vs: list, unifs: list | None,
                  anchor: list | None = None, anchor_radius: int = 2) -> dict:
    """``engine.vi.forward_sample`` over one row's slabs: ``vs`` the
    velocity's slabs ``(B, 3, Dl, H, W)``, ``unifs`` the uniform voxel
    noise's (None without a noise magnitude), ``anchor`` the row's slabs'
    anchors (:func:`make_chain_anchor_slabs`) on the ``"anchor"`` path.  Field
    results are lists of slabs; the counts ``(B,)`` are summed on the row's
    first device."""
    tr, dims = bundle.transformation, tuple(bundle.dims)
    if bundle._sobolev_kernel is not None:
        ks = [bundle.sobolev_kernel_on(dev) for dev in row.devices]
        vs = list(SobolevSmoothSlabs.apply(row.n, *ks, *vs))
    B = vs[0].shape[0]
    zero = torch.zeros((B,), dtype=torch.int64, device=row.dev0)
    anchor_sat = zero
    if images.path == "gather":
        trans, disp = _gather_slabs(tr, row, vs, dims)
        pts = trans if unifs is None else [t + _to_normalised(u, dims)
                                           for t, u in zip(trans, unifs)]
        warped = [grid_sample(m, p) for m, p in zip(images.moving, pts)]
        clamp_bound = math.inf  # no warp of this path clamps
    else:
        cascade = images.path == "cascade"
        disp, warped = _integrate_slabs(tr, vs, images.moving if cascade else None)
        trans = [_identity_slab(dims, d.device, z0, row.dl) + _to_normalised(d, dims)
                 for d, z0 in zip(disp, row.z0)]
        clamp_bound = float(tr.image_clamp_bound if cascade else tr.displacement_clamp_bound)
        if cascade and unifs is not None:
            warped = [w[:, 0] for w in _warp_slabs([w[:, None] for w in warped], unifs,
                                                   _noise_radius(bundle))]
        elif images.path == "grid":
            warped = [grid_sample(m, t + _to_normalised(u, dims))
                      for m, t, u in zip(images.moving, trans, unifs)]
        elif images.path == "anchor":
            warped, anchor_sat = _anchored_warp_slabs(disp, unifs, anchor, anchor_radius)
        elif images.path == "block":
            block, radius = int(bundle.block_size), int(bundle.block_radius)
            bound = block_warp_bound(bundle)
            d_total = [d + u for d, u in zip(disp, unifs)]
            vols = [m.expand((B, 1) + tuple(m.shape)).contiguous() for m in images.moving]
            warped = [w[:, 0] for w in warp_block_gather_slabs(vols, d_total, bound, radius,
                                                               block, images.h)]
            anchor_sat = block_residual_overflow_slabs([d.detach() for d in d_total], bound,
                                                       radius, block)
    folds = [torch.sum(det_jacobian(j) < 0.0, dim=(-3, -2, -1))
             for j in _gradient_slabs([t.detach() for t in trans], dims, normalised=True)]
    residuals = [f - w for f, w in zip(images.lcn_fixed, _lcn_slabs(bundle.gmm, warped))]
    if math.isinf(clamp_bound):
        sat = zero
    else:
        sat = sum_slabs([torch.sum(torch.any(torch.abs(d.detach()) >= clamp_bound, dim=-4),
                                   dim=(-3, -2, -1)) for d in disp])
    return {"v": vs, "displacement": disp, "transformation": trans, "warped": warped,
            "residuals": residuals, "ndv": sum_slabs(folds), "sat": sat + anchor_sat,
            "sat_resid": anchor_sat}


def _vd_alpha(bundle, gmm: dict, residuals: list, masks: list, dev0) -> torch.Tensor:
    """``engine.vi.vd_alpha`` of sharded residuals (detached), on ``dev0``."""
    if not bundle.virtual_decimation:
        return torch.ones(residuals[0].shape[:-3], dtype=torch.float32, device=dev0)
    with torch.no_grad():
        rescaled = [bundle.gmm.rescale_residuals(_on(gmm, r.device), r.detach(), m)
                    for r, m in zip(residuals, masks)]
        masked = [torch.where(m, r, torch.zeros_like(r)) for r, m in zip(rescaled, masks)]
        vox = (-3, -2, -1)
        return GMM.vd_factor_from_sums(sum_slabs([torch.sum(m, dim=vox) for m in masks]),
                                       sum_slabs([torch.sum(r ** 2, dim=vox) for r in masked]),
                                       *lag1_sums_slabs(masked))


def _masked_nll(bundle, gmm: dict, residuals: list, masks: list) -> torch.Tensor:
    """``GMM.masked_nll`` of sharded residuals, summed on the parameters'
    device (differentiable in both)."""
    dev0 = next(iter(gmm.values())).device
    return sum_slabs([bundle.gmm.masked_nll(_on(gmm, r.device), r, m)
                      for r, m in zip(residuals, masks)], dev0)


def _gmm_adam_step(bundle, opt, gmm: dict, opt_state, residuals: list, masks: list, alpha):
    """``engine.vi.gmm_adam_step`` on sharded residuals."""
    res_d = [r.detach() for r in residuals]
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in gmm.items()}
        loss = _masked_nll(bundle, p, res_d, masks) * alpha - bundle.gmm_prior_terms(p)
        keys = list(p)
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in keys])
    updates, opt_state = opt.update(dict(zip(keys, grads)), opt_state)
    return apply_updates({k: v.detach() for k, v in gmm.items()}, updates), opt_state


def _draw_slab(gen: torch.Generator, shape: tuple, k: int, row: _Row, normal: bool,
               alpha: float = 0.0) -> torch.Tensor:
    """The whole draw of ``shape`` from ``gen`` on slab ``k``'s device, its
    slab kept (the unsharded run's draw, cut)."""
    dev = row.devices[k]
    if normal:
        whole = torch.randn(shape, generator=gen, device=dev)
    else:
        whole = uniform_voxel_noise(gen, shape, alpha, dev)
    return whole.narrow(-3, row.z0[k], row.dl)


def _chain_noise_slabs(bundle, shards: list, row: _Row) -> tuple:
    """``engine.mcmc._chain_noise`` per slab: each shard draws its chains'
    whole ``eps`` and ``unif`` from the chains' generators and keeps its
    slab (``unif`` None without a noise magnitude)."""
    s0 = shards[0]
    field = (3,) + tuple(bundle.field_dims)
    dense = (3,) + tuple(bundle.dims)
    alpha = bundle.uniform_noise_alpha
    eps, unif = [], []
    for k, dev in enumerate(row.devices):
        e, u = [], []
        for c in range(s0.v.shape[0]):
            gen = key_generator(s0.key[c], s0.step, dev)
            e.append(_draw_slab(gen, field, k, row, True))
            if alpha is not None:
                u.append(_draw_slab(gen, dense, k, row, False, float(alpha)))
        eps.append(torch.stack(e))
        if u:
            unif.append(torch.stack(u))
    return eps, (unif if alpha is not None else None)


def make_sgld_transition_slabs(bundle, opt_gmm, opt_reg, tau: float, images: _Images,
                               row: _Row, anchor_radius: int = 2):
    """``transition(shards, collect_weight, noise=None, anchor=None) ->
    (shards, metrics)``: ``engine.mcmc.make_sgld_transition`` (per-chain
    sets) over one row's shards (``MCMCState``\\ s of the row's chains,
    each with its D-slab of the fields).  ``noise``: ``(eps, unif)``, lists
    of the slabs' draws; without it each shard draws its own.  ``anchor``:
    the row's anchor on the ``"anchor"`` path.  Metrics are on the row's
    first device."""
    dev0 = row.dev0
    masks = images.mask
    learnable_reg = bundle.reg_loss.learnable and len(bundle.reg_loss.param_names) > 0

    def transition(shards: list, collect_weight: float, noise=None, anchor=None):
        s0 = shards[0]
        eps, unif = noise if noise is not None else _chain_noise_slabs(bundle, shards, row)
        with torch.enable_grad():
            v_noised = [(s.v + langevin_noise(None, s.sigma, tau, e)).detach().requires_grad_(True)
                        for s, e in zip(shards, eps)]
            reg_keys = list(s0.reg)
            reg_p = {k: s0.reg[k].detach().requires_grad_(learnable_reg) for k in reg_keys}
            out = forward_slabs(bundle, images, row, v_noised, unif, anchor, anchor_radius)
            res = out["residuals"]
            alpha = _vd_alpha(bundle, s0.gmm, res, masks, dev0)
            gmm, opt_gmm_state = _gmm_adam_step(bundle, opt_gmm, s0.gmm, s0.opt_gmm, res,
                                                masks, alpha)
            data_c = _masked_nll(bundle, gmm, res, masks) * alpha - bundle.gmm_prior_terms(gmm)
            reg, log_y, loc_prior, per_set = _reg_terms(bundle, reg_p, None,
                                                        _energy(bundle, out["v"]))
            reg_c = reg - loc_prior - per_set
            wrt = v_noised + ([reg_p[k] for k in reg_keys] if learnable_reg else [])
            grads = torch.autograd.grad((data_c + reg_c).sum(), wrt)
        n = len(shards)
        reg_new, opt_reg_state = s0.reg, s0.opt_reg
        if learnable_reg:
            upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[n:])), s0.opt_reg)
            reg_new = apply_updates({k: t.detach() for k, t in s0.reg.items()}, upd)
        new = []
        for s, vn, g, d in zip(shards, v_noised, grads[:n], out["displacement"]):
            dev = vn.device
            w = welford_update(WelfordState(s.welford.count, s.welford.mean, s.welford.m2),
                               d.detach(), collect_weight)
            new.append(s._replace(
                v=vn.detach() - tau * s.sigma ** 2 * g, gmm=_on(gmm, dev),
                reg=_on(reg_new, dev), opt_gmm=_on(opt_gmm_state, dev),
                opt_reg=_on(opt_reg_state, dev), welford=w))
        metrics = {"data_term": data_c, "reg_term": reg_c, "vd_alpha": alpha,
                   "reg_energy": torch.exp(log_y), "ndv": out["ndv"], "sat": out["sat"],
                   "sat_resid": out["sat_resid"], "gmm_scales": GMM.scales(gmm),
                   "gmm_proportions": GMM.proportions(gmm)}
        return new, {k: t.detach() for k, t in metrics.items()}

    return transition


def _rows(bundle, mesh: Mesh, blend_radius: int = 1) -> list:
    """The rows of the ``'space'`` axis; raises where a slab is too thin for
    the step's stencils: 2 planes (the Taylor squaring, the radius-1 blend
    warps), ``2R`` for the ``"pre"`` scheme's noise warp of radius ``R``
    and for a blend warp of radius ``blend_radius`` (the anchored
    ``"blend"`` mode's)."""
    depth = int(bundle.dims[0])
    if "space" not in mesh.axis_names:
        raise ValueError(f"a spatially sharded step needs a 'space' axis, got {mesh}")
    n = mesh.shape["space"]
    if depth % n:
        raise ValueError(f"depth {depth} does not divide over {n} shards")
    need = max(2, 2 * int(blend_radius))
    if image_path(bundle) == "cascade" and bundle.uniform_noise_alpha is not None:
        need = max(need, 2 * _noise_radius(bundle))
    if depth // n < need:
        raise ValueError(f"{depth} planes over {n} shards leave {depth // n} per slab; the "
                         f"step's stencils need {need} (the noise warp's 2R at alpha "
                         f"{bundle.uniform_noise_alpha})")
    return [_Row(mesh, idx, depth) for idx in mesh.rows("space")]


def _cut_chain_noise(noise, row: _Row, r: int, n_rows: int) -> tuple:
    """One step's whole ``(eps, unif)`` ``(C, 3, …)`` cut to row ``r``'s
    chains and each of its slabs (``unif`` may be None)."""
    return tuple(None if t is None else [row.cut(t.chunk(n_rows)[r], k) for k in range(row.n)]
                 for t in noise)


def make_mcmc_chunk_sharded(bundle, opt_gmm, opt_reg, tau: float, fixed: Sharded,
                            moving: Sharded, chunk: int, burn_in: int, thin: int,
                            anchored: bool = False, anchor_radius: int = 2,
                            anchor_mode: str = "taylor", anchor_period: int = 1):
    """``engine.mcmc.make_mcmc_chunk`` over the mesh of ``fixed`` (a
    ``('chain', 'space')`` or ``('space',)`` mesh; images from
    ``shard_images_spatial``): ``run(state, noise=None) -> (state,
    metrics)`` on a ``shard_state_spatial`` state.  Each row of the
    ``'space'`` axis runs its chains' transition over its slabs; the rows
    take turns at every transition (``run_in_turns``).  ``noise``: a
    sequence of ``chunk`` whole ``(eps, unif)`` draws over all chains, on
    any device.  Metrics ``(chunk, C, …)`` come back on the mesh's first
    device.  ``anchored`` (the caller applies the JAX package's fallbacks):
    each row re-anchors its chains every ``anchor_period`` transitions from
    the chunk's start (:func:`make_chain_anchor_slabs`)."""
    _refuse(bundle)
    mesh = fixed.mesh
    blend = anchored and anchor_mode == "blend"
    rows = _rows(bundle, mesh, anchor_radius if blend else 1)
    moving_whole = gather(moving)
    images = [_Images(bundle, fixed, moving, row, moving_whole, anchored) for row in rows]
    transitions = [make_sgld_transition_slabs(bundle, opt_gmm, opt_reg, tau, im, row,
                                              anchor_radius) for im, row in zip(images, rows)]
    anchor_fns = [make_chain_anchor_slabs(bundle, im, row, anchor_mode) if anchored else None
                  for im, row in zip(images, rows)]

    def step_fn(r: int, feed):
        taken, anchor = [0], [None]

        def step(shards):
            with span(MCMC_STEP):
                if anchor_fns[r] is not None and taken[0] % anchor_period == 0:
                    anchor[0] = anchor_fns[r](shards)
                taken[0] += 1
                n = shards[0].step + 1
                noise = (None if feed is None
                         else _cut_chain_noise(next(feed), rows[r], r, len(rows)))
                shards, metrics = transitions[r](shards, _sgld_weight(n, burn_in, thin), noise,
                                                 anchor[0])
                return [s._replace(step=n) for s in shards], metrics

        return step

    def run(state: Sharded, noise=None):
        feeds = [None if noise is None else iter(noise) for _ in rows]
        states, metrics = run_in_turns([step_fn(r, feeds[r]) for r in range(len(rows))],
                                       [[state[i] for i in row.idx] for row in rows], chunk)
        trees = [None] * mesh.size
        for row, shards in zip(rows, states):
            for i, s in zip(row.idx, shards):
                trees[i] = s
        dev0 = mesh.device_list[0]
        return Sharded(trees, mesh, state.cuts), {
            k: torch.cat([m[k].to(dev0) for m in metrics], dim=1) for k in metrics[0]}

    return run


def _vi_draws_slabs(bundle, shards: list, row: _Row) -> tuple:
    """``engine.vi._draws`` per slab: each shard draws the step's whole
    ``eps`` and ``unif`` from the state's generator and keeps its slab, and
    the same scalar ``x``."""
    s0 = shards[0]
    field = (3,) + tuple(bundle.field_dims)
    alpha = bundle.uniform_noise_alpha
    eps, xs, unif = [], [], []
    for k, dev in enumerate(row.devices):
        gen = key_generator(s0.key, s0.step, dev)
        eps.append(_draw_slab(gen, field, k, row, True))
        xs.append(torch.randn((), generator=gen, dtype=torch.float32, device=dev))
        if alpha is not None:
            unif.append(_draw_slab(gen, (2, 3) + tuple(bundle.dims), k, row, False,
                                   float(alpha)))
    return eps, xs, (unif if alpha is not None else None)


def make_vi_step_sharded(bundle, opt_q_v, opt_gmm, opt_reg, fixed: Sharded, moving: Sharded):
    """``engine.vi.make_vi_step`` over the ``('space',)`` mesh of ``fixed``
    (images from ``shard_images_spatial``): ``step(state, noise=None) ->
    (state, metrics)`` on a ``shard_tree_spatial`` state.  The antithetic
    pair runs as one batch of 2 over the slabs; the two GMM Adam steps, the
    entropy and the losses are formed from sums over the slabs on the
    mesh's first device; the three Adam updates are per slab.  ``noise``:
    the whole ``(eps, x, unif)``, on any device."""
    _refuse(bundle)
    mesh = fixed.mesh
    rows = _rows(bundle, mesh)
    if len(rows) != 1:
        raise ValueError(f"the sharded VI step takes a mesh with one row of 'space', got {mesh}")
    row = rows[0]
    images = _Images(bundle, fixed, moving, row, gather(moving))
    reg_loss = bundle.reg_loss
    learnable_reg = reg_loss.learnable and len(reg_loss.param_names) > 0
    masks, dev0 = images.mask, row.dev0
    q_keys = ("mu", "log_var", "u")

    def step(state: Sharded, noise=None):
        with span(VI_STEP):
            return _step(state, noise)

    def _step(state: Sharded, noise):
        shards = [state[i] for i in row.idx]
        s0 = shards[0]
        if noise is None:
            eps, xs, unif = _vi_draws_slabs(bundle, shards, row)
        else:
            e, x, u = noise
            eps = [row.cut(e, k) for k in range(row.n)]
            xs = [x.to(dev) for dev in row.devices]
            unif = None if u is None else [row.cut(u, k) for k in range(row.n)]
        with torch.enable_grad():
            q = [{k: s.q_v[k].detach().requires_grad_(True) for k in q_keys} for s in shards]
            reg_keys = list(s0.reg)
            reg_p = {k: s0.reg[k].detach().requires_grad_(learnable_reg) for k in reg_keys}
            vs = [torch.stack(sample_q_v(None, qi, antithetic=True, eps=e, x=x))
                  for qi, e, x in zip(q, eps, xs)]
            out = forward_slabs(bundle, images, row, vs, unif)
            reg, log_ys = reg_loss._loss(reg_p, _energy(bundle, out["v"]))
            sums = [sum_slabs(p, dev0) for p in zip(*(
                entropy_sample_sums(v, qi["mu"], qi["log_var"], qi["u"])
                for v, qi in zip(vs, q)))]
            ents = entropy_sample_from_sums(*sums)
            analytic = entropy_analytic_from_sums(*(sum_slabs(p, dev0) for p in zip(*(
                entropy_analytic_sums(qi["log_var"], qi["u"]) for qi in q))))
            gmm, opt_gmm_state = s0.gmm, s0.opt_gmm
            datas, alphas = [], []
            for i in range(2):
                res = [r[i] for r in out["residuals"]]
                a = _vd_alpha(bundle, gmm, res, masks, dev0)
                gmm, opt_gmm_state = _gmm_adam_step(bundle, opt_gmm, gmm, opt_gmm_state, res,
                                                    masks, a)
                datas.append(_masked_nll(bundle, gmm, res, masks) * a)
                alphas.append(a)
            data_term = 0.5 * (datas[0] + datas[1]) - bundle.gmm_prior_terms(gmm)
            reg_term = 0.5 * (reg[0] + reg[1])
            if learnable_reg and isinstance(reg_loss, RegLossLogNormal):
                reg_term = reg_term - 0.5 * (bundle.reg_loc_prior(log_ys[0])
                                             + bundle.reg_loc_prior(log_ys[1]))
                reg_term = reg_term - bundle.reg_scale_prior(reg_p["log_scale"])
            elif learnable_reg and isinstance(reg_loss, RegLossL2):
                reg_term = reg_term - bundle.reg_w_reg_prior(reg_p["log_w_reg"])
            entropy_term = 0.5 * (ents[0] + ents[1]) + analytic
            loss = data_term + reg_term - entropy_term
            wrt = [qi[k] for qi in q for k in q_keys]
            if learnable_reg:
                wrt += [reg_p[k] for k in reg_keys]
            grads = torch.autograd.grad(loss.sum(), wrt)
        n3 = 3 * row.n
        reg_new, opt_reg_state = s0.reg, s0.opt_reg
        if learnable_reg:
            upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[n3:])), s0.opt_reg)
            reg_new = apply_updates({k: t.detach() for k, t in s0.reg.items()}, upd)
        metrics = {"data_term": data_term, "reg_term": reg_term, "entropy_term": entropy_term,
                   "total_loss": loss, "vd_alpha": alphas[0],
                   "reg_energy": torch.exp(log_ys[0]), "ndv": out["ndv"][0],
                   "sat": out["sat"][0], "sat_resid": out["sat_resid"][0]}
        metrics = {k: t.detach() for k, t in metrics.items()}
        new, max_upd = [], {name: [] for name in q_keys}
        for k, s in enumerate(shards):
            dev = s.q_v["mu"].device
            g = dict(zip(q_keys, grads[3 * k:3 * k + 3]))
            upd, opt_q = opt_q_v.update(g, s.opt_q_v)
            q_new = apply_updates({name: s.q_v[name].detach() for name in q_keys}, upd)
            for name in q_keys:
                old_n = torch.linalg.vector_norm(s.q_v[name], dim=-4)
                new_n = torch.linalg.vector_norm(q_new[name], dim=-4)
                max_upd[name].append(torch.amax(torch.abs(new_n - old_n)).to(dev0))
            new.append(s._replace(q_v=q_new, gmm=_on(gmm, dev), reg=_on(reg_new, dev),
                                  opt_q_v=opt_q, opt_gmm=_on(opt_gmm_state, dev),
                                  opt_reg=_on(opt_reg_state, dev), step=s.step + 1))
        for name in q_keys:
            metrics[f"max_update_{name}"] = torch.amax(torch.stack(max_upd[name]))
        metrics["gmm_scales"] = GMM.scales(gmm)
        metrics["gmm_proportions"] = GMM.proportions(gmm)
        trees = list(state)
        for i, s in zip(row.idx, new):
            trees[i] = s
        return Sharded(trees, mesh, state.cuts), metrics

    return step


__all__ = ["unported", "image_path", "forward_slabs", "make_chain_anchor_slabs",
           "make_sgld_transition_slabs",
           "make_mcmc_chunk_sharded", "make_vi_step_sharded"]
