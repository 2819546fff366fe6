"""The spatially sharded SG-MCMC and VI steps: the whole training step cut
along D over the ``'space'`` axis of a mesh (no JAX counterpart module: the
JAX package hands the step to GSPMD's partitioner with Pallas off,
``ir_sgmcmc_tpu/trainer.py:826-866`` and ``:1187-1211``).

The port has no partitioner, so the slabs are explicit: a step runs over
the D-slabs of one row of the ``'space'`` axis as ONE Python function and
one autograd graph, and it runs the engine's own code there.  The forward
chain (``engine.vi.forward_sample``'s, under every option of the dense
``SVF3D``), the anchor, the likelihood, the regulariser, the entropy, the
MCMC potential and the VI loss take the row (:class:`_Row`) as their
layout (``ops/_layout.py``), with fields :class:`_Slabs`.  The row supplies
what differs from one device: the stencils that read across a cut, by the
halo ops of ``parallel/halo.py`` (B1Z-B7Z on the card); the samples of a
whole field (the ``use_gather`` squarings all-gather it; the image paths
that sample the moving image read the whole image, which each shard
holds); and the sums over voxels, per-slab partial sums added on the row's
first device, where the scalar work runs (the GMM Adam steps, the
hyperpriors, the reg-parameter Adam).  This module keeps the placement: the
images, the draws, the per-slab updates and the chunk and step functions.

Noise is the unsharded draw, cut: each shard draws its chains' whole field
from the chains' generators (``engine.vi.key_generator``) on its own device
and keeps its slab, so a sharded run takes the unsharded run's draws on the
same device type.  Nothing in a step waits on a device.  Per-chain
parameter sets only, as in the JAX trainer.
"""

from __future__ import annotations

import functools
import math

import torch

from ..engine.mcmc import (WelfordState, _chain_noise, _potential, _sgld_step,
                           _transition_metrics, make_chain_anchor, welford_update)
from ..engine.vi import (_draws, _elbo, _forward_chain, block_warp_bound, image_path,
                         key_generator)
from ..kernels.lcn_residual import _lcn
from ..models.gmm import GMM
from ..models.sampler import langevin_noise, sample_q_v
from ..models.transformation import SVF3D
from ..ops.grids import _axis_scale_on, identity_grid
from ..ops.resample import grid_sample_each
from ..ops.stencil import _fwd_diff_axis
from ..optim.adam_decay import apply_updates
from ..utils.spans import VI_STEP, span
from .halo import (HaloWarp, SobolevSmoothSlabs, _each, _exchange_halo_d, _lifted, _Slabs,
                   allgather_slabs, block_halo, block_residual_overflow_slabs, box_filter3d_slabs,
                   fourier_energy_slabs, fwd_diff_d_slabs, lag1_sums_slabs, split_compose_slabs,
                   sum_slabs, taylor_compose_slabs, taylor_squaring_slabs,
                   warp_block_gather_slabs)
from .mesh import Mesh, Sharded, _map, gather, halo_images_spatial, run_in_turns


def unported(bundle) -> str | None:
    """Why the spatially sharded step does not take ``bundle``'s problem
    (None: it does).  It takes the dense ``SVF3D`` under every option, the
    one model whose fields the JAX trainer cuts along D (a dense field,
    ``ir_sgmcmc_tpu/trainer.py:837`` and ``:1199``)."""
    tr = bundle.transformation
    if not isinstance(tr, SVF3D):
        return (f"the spatially sharded step takes the dense SVF3D, not {type(tr).__name__}, "
                f"whose fields the JAX trainer does not cut either")
    return None


def _on(tree, device):
    """A tree's tensors on ``device`` (a no-op where they are)."""
    return _map(lambda x, host: x if host else x.to(device, non_blocking=True), tree)


@functools.lru_cache(maxsize=64)
def _identity_slab(dims: tuple, device: torch.device, z0: int, dl: int) -> torch.Tensor:
    """The normalised identity grid's planes ``[z0, z0 + dl)``, made once per
    device (its values are the whole grid's)."""
    return identity_grid(dims, device=device)[:, z0:z0 + dl].contiguous()


class _Row:
    """One row of the ``'space'`` axis (its flat mesh indices, devices and
    each slab's first plane) and the layout of fields of ``dims`` cut over
    it: the operations of ``ops._layout.OneDevice`` and ``engine.vi``'s
    block warp on ``_Slabs``."""

    def __init__(self, mesh: Mesh, idx: list, dims):
        self.dims = tuple(int(n) for n in dims)
        self.idx = list(idx)
        self.devices = [mesh.device_list[i] for i in self.idx]
        self.dev0 = self.devices[0]
        self.n = len(self.idx)
        self.dl = self.dims[0] // self.n
        self.z0 = [k * self.dl for k in range(self.n)]

    def cut(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """Slab ``k`` of a whole field (along D), on its device."""
        return t.narrow(-3, self.z0[k], self.dl).to(self.devices[k])

    taylor_squaring = _lifted(taylor_squaring_slabs)
    split_compose = _lifted(split_compose_slabs)
    taylor_compose = _lifted(taylor_compose_slabs)
    box_filter = _lifted(box_filter3d_slabs)
    lag1_sums = _lifted(lag1_sums_slabs)
    total = _lifted(sum_slabs)

    def map(self, fn, *args):
        return _each(fn, *args)

    def integrate(self, transformation: SVF3D, v: _Slabs, **kwargs) -> tuple:
        return transformation.integrate(v, layout=self, **kwargs)

    def local(self, tree) -> _Slabs:
        return _Slabs(_on(tree, dev) for dev in self.devices)

    def identity(self, dims, like: _Slabs) -> _Slabs:
        return _Slabs(_identity_slab(tuple(dims), p.device, z0, self.dl)
                      for p, z0 in zip(like.parts, self.z0))

    def to_normalised(self, x: _Slabs) -> _Slabs:  # at the volume's dims, not the slab's
        return _each(lambda p: p * _axis_scale_on(self.dims, p.device, True), x)

    def to_voxel(self, x: _Slabs) -> _Slabs:
        return _each(lambda p: p * _axis_scale_on(self.dims, p.device, False), x)

    def split_operand(self, u: _Slabs) -> list:
        return [t.contiguous() for t in _exchange_halo_d(u.parts, 1)]

    def warp(self, vol: _Slabs, disp: _Slabs, radius: int = 1) -> _Slabs:
        return _Slabs(HaloWarp.apply(int(radius), self.n, *(v.contiguous() for v in vol.parts),
                                     *(d.contiguous() for d in disp.parts)))

    def gather_sample(self, d: _Slabs, id_grid: _Slabs) -> _Slabs:
        return _Slabs(grid_sample_each(w, i + p) for p, w, i in
                      zip(d.parts, allgather_slabs(d.parts), id_grid.parts))

    def gradient(self, x: _Slabs, normalised: bool = False) -> _Slabs:
        D, H, W = self.dims
        out = []
        for p, dz in zip(x.parts, fwd_diff_d_slabs(x.parts)):
            dx, dy = _fwd_diff_axis(p, -1), _fwd_diff_axis(p, -2)
            if normalised:
                dx, dy, dz = dx * ((W - 1) / 2.0), dy * ((H - 1) / 2.0), dz * ((D - 1) / 2.0)
            out.append(torch.stack([dx, dy, dz], dim=p.ndim - 3))
        return _Slabs(out)

    def fourier_energy(self, v: _Slabs) -> torch.Tensor:
        return fourier_energy_slabs(v.parts, self.dims)

    def smooth(self, bundle, v: _Slabs) -> _Slabs:
        if bundle._sobolev_kernel is None:
            return v
        ks = [bundle.sobolev_kernel_on(dev) for dev in self.devices]
        return _Slabs(SobolevSmoothSlabs.apply(self.n, *ks, *v.parts))

    def block_warp(self, vol: _Slabs, disp: _Slabs, bound: int, radius: int,
                   block: int) -> _Slabs:  # on each slab's window (_Images)
        return _Slabs(warp_block_gather_slabs(vol.parts, disp.parts, bound, radius, block,
                                              block_halo(bound, radius)))

    def block_overflow(self, disp: _Slabs, bound: int, radius: int, block: int):
        return block_residual_overflow_slabs(disp.parts, bound, radius, block)

    def residual_map(self, gmm: GMM, fixed: dict, warped: _Slabs) -> _Slabs:
        return fixed["lcn"] - _lcn(warped, gmm.radius, self.box_filter)


class _Images:
    """One row's images, placed once when a step is built, as the forward chain
    reads them on the row: ``fixed`` the fixed image's and the mask's slabs
    and the fixed image's LCN; ``moving["im"]`` what each slab's image warp
    reads of the moving image (``engine.vi.image_path``): a window of
    ``block_halo`` planes on each side of its slab (the block-gather warp),
    its slab (the cascade, whose warps exchange the halos) or the whole
    image (the paths that sample it)."""

    def __init__(self, bundle, fixed: Sharded, moving: Sharded, row: _Row,
                 moving_whole: dict, anchored: bool = False):
        self.row = row
        im = _Slabs(fixed[i]["im"] for i in row.idx)
        with torch.no_grad():
            lcn = _lcn(im, bundle.gmm.radius, row.box_filter)
        self.fixed = {"im": im, "mask": _Slabs(fixed[i]["mask"] for i in row.idx), "lcn": lcn}
        path = image_path(bundle, anchored)
        if path == "block":
            h = block_halo(block_warp_bound(bundle), bundle.block_radius)
            placed = halo_images_spatial({"im": moving_whole["im"]}, fixed.mesh,
                                         int(bundle.dims[0]), h)
            slabs = [placed[i]["im"] for i in row.idx]
        elif path == "cascade":
            slabs = [moving[i]["im"] for i in row.idx]
        else:
            slabs = [moving_whole["im"].to(dev) for dev in row.devices]
        self.moving = {"im": _Slabs(slabs)}


def forward_slabs(bundle, images: _Images, vs: list, unifs: list | None,
                  anchor: dict | None = None, anchor_radius: int = 2) -> dict:
    """``engine.vi.forward_sample`` over one row's slabs: ``vs`` the
    velocity's slabs ``(B, 3, Dl, H, W)``, ``unifs`` the uniform voxel
    noise's (None without a noise magnitude), ``anchor`` the row's anchor
    (``engine.mcmc.make_chain_anchor`` on the row) on the ``"anchor"``
    path.  Field results are lists of slabs; the counts ``(B,)`` are on the
    row's first device."""
    out = _forward_chain(bundle, images.row, images.fixed, images.moving, _Slabs(vs),
                         None if unifs is None else _Slabs(unifs), anchor, False, anchor_radius)
    return {k: t.parts if isinstance(t, _Slabs) else t for k, t in out.items()}


def _slabs_of(out: dict) -> dict:
    """:func:`forward_slabs`'s results, their lists of slabs as ``_Slabs``."""
    return {k: _Slabs(t) if isinstance(t, list) else t for k, t in out.items()}


def _chain_noise_slabs(bundle, shards: list, row: _Row) -> tuple:
    """``engine.mcmc._chain_noise`` drawn on each slab's device and cut to
    its slab (``unif`` None without a noise magnitude)."""
    draws = [_chain_noise(bundle, shards[0], dev) for dev in row.devices]
    return tuple(None if d[0] is None else [row.cut(t, k).contiguous() for k, t in enumerate(d)]
                 for d in zip(*draws))


class _RowState(list):
    """One row's chain shards, read as ``engine.mcmc._sgld_step`` reads an
    ``MCMCState``."""

    v = property(lambda self: _Slabs(s.v for s in self))
    step = property(lambda self: self[0].step)

    def _replace(self, step: int) -> "_RowState":
        return _RowState(s._replace(step=step) for s in self)


def make_sgld_transition_slabs(bundle, opt_gmm, opt_reg, tau: float, images: _Images,
                               anchor_radius: int = 2):
    """``transition(shards, collect_weight, noise=None, anchor=None) ->
    (shards, metrics)``: ``engine.mcmc.make_sgld_transition`` (per-chain
    sets) over one row's shards (a ``_RowState`` of the row's chains, each
    shard with its D-slab of the fields): the engine's potential on the
    row, then the Langevin step and the Welford update per slab.
    ``noise``: ``(eps, unif)``, lists of the slabs' draws; without it each
    shard draws its own.  ``anchor``: the row's anchor on the ``"anchor"``
    path.  Metrics are on the row's first device."""
    row = images.row
    learnable_reg = bundle.reg_loss.learnable and len(bundle.reg_loss.param_names) > 0

    def transition(shards: _RowState, collect_weight: float, noise=None, anchor=None):
        s0 = shards[0]
        eps, unif = noise if noise is not None else _chain_noise_slabs(bundle, shards, row)
        with torch.enable_grad():
            v_noised = [(s.v + langevin_noise(None, s.sigma, tau, e)).detach().requires_grad_(True)
                        for s, e in zip(shards, eps)]
            reg_keys = list(s0.reg)
            reg_p = {k: s0.reg[k].detach().requires_grad_(learnable_reg) for k in reg_keys}
            out = _slabs_of(forward_slabs(bundle, images, v_noised, unif, anchor, anchor_radius))
            loss, aux = _potential(bundle, opt_gmm, images.fixed["mask"], out, reg_p, s0.gmm,
                                   s0.opt_gmm, layout=row)
            wrt = v_noised + ([reg_p[k] for k in reg_keys] if learnable_reg else [])
            grads = torch.autograd.grad(loss.sum(), wrt)
        n = len(shards)
        reg_new, opt_reg_state = s0.reg, s0.opt_reg
        if learnable_reg:
            upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[n:])), s0.opt_reg)
            reg_new = apply_updates({k: t.detach() for k, t in s0.reg.items()}, upd)
        new = _RowState()
        for s, vn, g, d in zip(shards, v_noised, grads[:n], aux["displacement"].parts):
            dev = vn.device
            w = welford_update(WelfordState(s.welford.count, s.welford.mean, s.welford.m2),
                               d.detach(), collect_weight)
            new.append(s._replace(
                v=vn.detach() - tau * s.sigma ** 2 * g, gmm=_on(aux["gmm"], dev),
                reg=_on(reg_new, dev), opt_gmm=_on(aux["opt_gmm"], dev),
                opt_reg=_on(opt_reg_state, dev), welford=w))
        return new, _transition_metrics(aux, s0.v.shape[0])

    return transition


def _rows(bundle, mesh: Mesh, blend_radius: int = 1) -> list:
    """The rows of the ``'space'`` axis; raises where a slab is too thin for
    the step's stencils: 2 planes (the Taylor squaring, the radius-1 blend
    warps), ``2R`` for the ``"pre"`` scheme's noise warp of radius ``R``
    and for a blend warp of radius ``blend_radius`` (the anchored
    ``"blend"`` mode's), and where :func:`unported` says why not."""
    why = unported(bundle)
    if why is not None:
        raise NotImplementedError(why)
    depth = int(bundle.dims[0])
    if "space" not in mesh.axis_names:
        raise ValueError(f"a spatially sharded step needs a 'space' axis, got {mesh}")
    n = mesh.shape["space"]
    if depth % n:
        raise ValueError(f"depth {depth} does not divide over {n} shards")
    need = max(2, 2 * int(blend_radius))
    if image_path(bundle) == "cascade" and bundle.uniform_noise_alpha is not None:
        need = max(need, 2 * max(1, math.ceil(float(bundle.uniform_noise_alpha))))
    if depth // n < need:
        raise ValueError(f"{depth} planes over {n} shards leave {depth // n} per slab; the "
                         f"step's stencils need {need} (the noise warp's 2R at alpha "
                         f"{bundle.uniform_noise_alpha})")
    return [_Row(mesh, idx, bundle.dims) for idx in mesh.rows("space")]


def _placed(state: Sharded, rows: list, row_shards: list) -> Sharded:
    """``state`` with each row's shards replaced by ``row_shards``'."""
    trees = list(state)
    for row, shards in zip(rows, row_shards):
        for i, s in zip(row.idx, shards):
            trees[i] = s
    return Sharded(trees, state.mesh, state.cuts)


def make_mcmc_chunk_sharded(bundle, opt_gmm, opt_reg, tau: float, fixed: Sharded,
                            moving: Sharded, chunk: int, burn_in: int, thin: int,
                            anchored: bool = False, anchor_radius: int = 2,
                            anchor_mode: str = "taylor", anchor_period: int = 1):
    """``engine.mcmc.make_mcmc_chunk`` over the mesh of ``fixed`` (a
    ``('chain', 'space')`` or ``('space',)`` mesh; images from
    ``shard_images_spatial``): ``run(state, noise=None) -> (state,
    metrics)`` on a ``shard_state_spatial`` state.  Each row of the
    ``'space'`` axis runs its chains' transitions over its slabs
    (``engine.mcmc._sgld_step``); the rows take turns at every transition
    (``run_in_turns``).  ``noise``: a sequence of ``chunk`` whole ``(eps,
    unif)`` draws over all chains, on any device.  Metrics ``(chunk, C,
    …)`` come back on the mesh's first device.  ``anchored`` (the caller
    applies the JAX package's fallbacks): each row re-anchors its chains
    every ``anchor_period`` transitions from the chunk's start
    (``engine.mcmc.make_chain_anchor`` on the row)."""
    mesh = fixed.mesh
    blend = anchored and anchor_mode == "blend"
    rows = _rows(bundle, mesh, anchor_radius if blend else 1)
    moving_whole = gather(moving)
    images = [_Images(bundle, fixed, moving, row, moving_whole, anchored) for row in rows]
    transitions = [make_sgld_transition_slabs(bundle, opt_gmm, opt_reg, tau, im, anchor_radius)
                   for im in images]
    anchor_fns = [make_chain_anchor(bundle, im.moving, anchor_mode, im.row) if anchored
                  else None for im in images]

    def cut(noise, r: int):
        """Row ``r``'s chains of each whole ``(eps, unif)`` ``(C, 3, …)``,
        cut to its slabs (``unif`` may be None)."""
        row = rows[r]
        return None if noise is None else (
            tuple(None if t is None else [row.cut(t.chunk(len(rows))[r], k)
                                          for k in range(row.n)] for t in nz) for nz in noise)

    def run(state: Sharded, noise=None):
        steps = [_sgld_step(transitions[r], burn_in, thin, anchor_fns[r], anchor_period,
                            cut(noise, r)) for r in range(len(rows))]
        states, metrics = run_in_turns(steps, [_RowState(state[i] for i in row.idx)
                                               for row in rows], chunk)
        dev0 = mesh.device_list[0]
        return _placed(state, rows, states), {
            k: torch.cat([m[k].to(dev0) for m in metrics], dim=1) for k in metrics[0]}

    return run


def make_vi_step_sharded(bundle, opt_q_v, opt_gmm, opt_reg, fixed: Sharded, moving: Sharded):
    """``engine.vi.make_vi_step`` over the ``('space',)`` mesh of ``fixed``
    (images from ``shard_images_spatial``): ``step(state, noise=None) ->
    (state, metrics)`` on a ``shard_tree_spatial`` state.  The antithetic
    pair runs as one batch of 2 over the slabs; the engine's loss
    (``engine.vi._elbo``) on the row's layout; the three Adam updates are
    per slab.  ``noise``: the whole ``(eps, x, unif)``, on any device."""
    mesh = fixed.mesh
    rows = _rows(bundle, mesh)
    if len(rows) != 1:
        raise ValueError(f"the sharded VI step takes a mesh with one row of 'space', got {mesh}")
    row = rows[0]
    images = _Images(bundle, fixed, moving, row, gather(moving))
    reg_loss = bundle.reg_loss
    learnable_reg = reg_loss.learnable and len(reg_loss.param_names) > 0
    dev0 = row.dev0
    q_keys = ("mu", "log_var", "u")

    def step(state: Sharded, noise=None):
        with span(VI_STEP):
            return _step(state, noise)

    def _step(state: Sharded, noise):
        shards = [state[i] for i in row.idx]
        s0 = shards[0]
        if noise is None:  # each shard's whole draw, engine.vi._draws on its device
            draws = [_draws(bundle, s.q_v, key_generator(s0.key, s0.step, dev), 2)
                     for s, dev in zip(shards, row.devices)]
        else:
            draws = [noise] * row.n
        eps = [row.cut(d[0], k) for k, d in enumerate(draws)]
        xs = [d[1].to(dev) for d, dev in zip(draws, row.devices)]
        unif = None if draws[0][2] is None else [row.cut(d[2], k) for k, d in enumerate(draws)]
        with torch.enable_grad():
            q = [{k: s.q_v[k].detach().requires_grad_(True) for k in q_keys} for s in shards]
            reg_keys = list(s0.reg)
            reg_p = {k: s0.reg[k].detach().requires_grad_(learnable_reg) for k in reg_keys}
            q_v = {k: _Slabs(qi[k] for qi in q) for k in q_keys}
            v = torch.stack(sample_q_v(None, q_v, antithetic=True, eps=_Slabs(eps),
                                       x=_Slabs(xs)))
            out = _slabs_of(forward_slabs(bundle, images, v.parts, unif))
            regs, log_ys = reg_loss(reg_p, out["v"], row)
            loss, gmm, opt_gmm_state, metrics = _elbo(
                bundle, opt_gmm, images.fixed["mask"], q_v, v, out["residuals"], regs, log_ys,
                (out["ndv"], out["sat"], out["sat_resid"]), reg_p, s0.gmm, s0.opt_gmm, row)
            wrt = [qi[k] for qi in q for k in q_keys]
            if learnable_reg:
                wrt += [reg_p[k] for k in reg_keys]
            grads = torch.autograd.grad(loss.sum(), wrt)
        n3 = 3 * row.n
        reg_new, opt_reg_state = s0.reg, s0.opt_reg
        if learnable_reg:
            upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[n3:])), s0.opt_reg)
            reg_new = apply_updates({k: t.detach() for k, t in s0.reg.items()}, upd)
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
        return _placed(state, rows, [new]), metrics

    return step


__all__ = ["unported", "image_path", "forward_slabs", "make_sgld_transition_slabs",
           "make_mcmc_chunk_sharded", "make_vi_step_sharded"]
