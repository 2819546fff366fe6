"""The system under test for one cell: the port's config layer, its states
and the chunk entries the trainer runs, built from the cell's files.

Everything else the benchmark needs from the program is read here too:
the states' leaves as rows (one row per chain, or per VI pair) for the
comparison, and the per-step loss from the metrics each call returns.

A configuration that the trainer would run with a phase's step cut along
D over ``s > 1`` devices (:func:`spatial_shards`) runs it so, placed as the
trainer places it: a
``('chain', 'space')`` mesh of ``(1, s)`` (VI: ``('space',)``), the state
cut by ``shard_state_spatial`` (VI: ``shard_tree_spatial``, after the GMM
warm-up on the first device) and the images by ``shard_images_spatial``;
the same chunk entries dispatch on the placement.  The comparison's copies
of such a state are gathered to the host.
"""

from __future__ import annotations

import copy
import math
from contextlib import contextmanager

import torch

from . import phantom


class Inputs:
    """What the benchmark makes from the seed and hands to both sides: the
    phantom pairs, each chain's start ``v0`` and every row's key words."""

    def __init__(self, seed: int, traffic: dict, dims, field_dims, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.pairs = phantom.phantom_pairs(gen, int(traffic["pairs"]), dims, device)
        n_pairs = len(self.pairs)
        if traffic["phase"] == "mcmc":
            if traffic["start"] != "noise":
                raise ValueError(f"no MCMC start {traffic['start']!r} (the cells start from noise)")
            chains = int(traffic["chains"])
            self.v0 = torch.randn((n_pairs, chains, 3) + tuple(field_dims), generator=gen,
                                  device=device)
            self.keys = torch.randint(0, 2 ** 32, (n_pairs, chains, 2), generator=gen,
                                      dtype=torch.int64, device=device).cpu()
        else:
            if traffic["start"] != "config":
                raise ValueError(f"no VI start {traffic['start']!r} (q(v) starts as configured)")
            self.v0 = None
            self.keys = torch.randint(0, 2 ** 32, (n_pairs, 2), generator=gen,
                                      dtype=torch.int64, device=device).cpu()


def configured(config: dict, traffic: dict, dims=None, compute_dtype=None) -> dict:
    """The configuration as the program and the reference read it: the
    traffic's noise scheme, the cell's sizes (a test may ask for smaller
    ones) and, for the precision control, the program's own bfloat16
    integrator."""
    cfg = copy.deepcopy(config)
    cfg["trainer"].setdefault("uniform_noise", {})["scheme"] = traffic["noise_scheme"]
    if dims is not None:
        cfg["data_loader"]["args"]["dims"] = [int(n) for n in dims]
    if compute_dtype is not None:
        cfg["transformation_module"]["args"]["compute_dtype"] = compute_dtype
    return cfg


def spatial_shards(cfg: dict, phase: str, bundle=None) -> int:
    """The devices the trainer cuts the phase's step over along D when it is
    given as many as the configuration asks for: ``trainer.spatial_shards``
    (SG-MCMC) or an explicit ``trainer.vi_spatial_shards`` (VI; ``"auto"``
    stays on one device) ``s > 1`` under ``trainer.distribute`` (the
    default), where the field is dense, D divides into ``s`` slabs, SG-MCMC
    keeps per-chain parameters, and each slab is a whole number of the block
    warp's blocks where the image warp is that warp; else 1.  ``bundle``:
    the configuration's model, built from ``cfg`` when not given.  A copy of
    ``Trainer._mcmc_spatial_shards``, ``_vi_spatial_shards`` and
    ``_spatial_fits`` (a test holds it equal)."""
    t = cfg["trainer"]
    if phase == "mcmc":
        shards = int(t.get("spatial_shards", 1))
    else:
        shards = t.get("vi_spatial_shards", "auto")
        if shards == "auto":
            return 1
        shards = int(shards)
    if shards <= 1 or not t.get("distribute", True):
        return 1
    if phase == "mcmc" and t.get("MCMC_params", "per_chain") != "per_chain":
        return 1
    from ir_sgmcmc_tpu_torch.parallel import spatial

    if bundle is None:
        from ir_sgmcmc_tpu_torch.config import Config

        bundle = Config(cfg, make_dirs=False).build_bundle()
    depth = int(bundle.dims[0])
    dense = tuple(bundle.field_dims) == tuple(bundle.dims)
    fits = (spatial.image_path(bundle) != "block"
            or (depth // shards) % int(bundle.block_size) == 0)
    return shards if dense and depth % shards == 0 and fits else 1


def vi_remat(cfg: dict) -> bool:
    """Whether VI runs its antithetic rows in turn under recompute: the
    configuration's ``trainer.vi_remat``, where ``"auto"`` (the default) is
    the trainer's rule, a dense float32 field of at least 100 MiB.  A copy
    of ``Trainer``'s rule (a test holds it equal)."""
    remat = cfg["trainer"].get("vi_remat", "auto")
    if remat == "auto":
        remat = 3 * 4 * math.prod(int(n) for n in cfg["data_loader"]["args"]["dims"]) \
            >= 100 * 1024 * 1024
    return bool(remat)


def _halved(res: torch.Tensor) -> torch.Tensor:
    """The second half of the batch replaced by the first half."""
    h = res.shape[0] // 2
    return torch.cat([res[:h], res[:h]] if res.shape[0] % 2 == 0 else [res[:h + 1], res[:h]])


@contextmanager
def _planted_residuals(broken, broken_slabs):
    """For the ``with`` block: the forward chain's residuals passed through
    ``broken`` (``vi.forward_sample``, ``mcmc.forward_sample``), and the
    sharded step's list of residual slabs through ``broken_slabs``
    (``spatial.forward_slabs``)."""
    from ir_sgmcmc_tpu_torch.engine import mcmc, vi
    from ir_sgmcmc_tpu_torch.parallel import spatial

    real, real_slabs = vi.forward_sample, spatial.forward_slabs

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        out["residuals"] = broken(out["residuals"])
        return out

    def faulty_slabs(*args, **kwargs):
        out = real_slabs(*args, **kwargs)
        out["residuals"] = broken_slabs(out["residuals"])
        return out

    vi.forward_sample = mcmc.forward_sample = faulty
    spatial.forward_slabs = faulty_slabs
    try:
        yield
    finally:
        vi.forward_sample = mcmc.forward_sample = real
        spatial.forward_slabs = real_slabs


def half_batch_fault():
    """A planted fault: the forward chain hands the second half of its
    batch the first half's residuals, as if half of the batch were left
    out and the rest stood in for it (on the sharded step, in every slab).
    Where the rows run one at a time (VI under remat) each call's batch is
    one row and the fault changes nothing; those cells are calibrated on
    :func:`half_sample_fault` instead."""
    return _planted_residuals(_halved, lambda slabs: [_halved(r) for r in slabs])


@contextmanager
def half_sample_fault():
    """A planted fault of VI: the antithetic pair's second sample is the
    first, as if the second half of the batch were left out and the mean
    taken over the rest.  It acts on the samples before the forward chain,
    so it also holds where the rows run one at a time (remat), and on each
    slab of the sharded step (``spatial.sample_q_v``)."""
    from ir_sgmcmc_tpu_torch.engine import vi
    from ir_sgmcmc_tpu_torch.parallel import spatial

    real = vi.sample_q_v

    def faulty(*args, antithetic=False, **kwargs):
        out = real(*args, antithetic=antithetic, **kwargs)
        return (out[0], out[0]) if antithetic else out

    vi.sample_q_v = spatial.sample_q_v = faulty
    try:
        yield
    finally:
        vi.sample_q_v = spatial.sample_q_v = real


def tile_fault(size: int = 8):
    """A planted fault confined to one ``size``³ tile of every row: the
    residuals of the tile at the volume's centre are its neighbour's along
    W, as if a tiled kernel wrote one tile in the wrong place (on the
    sharded step, in the slab that holds the centre)."""
    return _planted_residuals(lambda res: _tile(res, size),
                              lambda slabs: _tile_slabs(slabs, size, _tile))


def _tile(t: torch.Tensor, size: int, z: int | None = None) -> torch.Tensor:
    """``t`` with the ``size``³ tile at its volume's centre (at plane ``z``
    along D, where given) holding its neighbour's values along W."""
    t = t.clone()
    y, x = (n // 2 // size * size for n in t.shape[-2:])
    z = t.shape[-3] // 2 // size * size if z is None else z
    t[..., z:z + size, y:y + size, x:x + size] = t[..., z:z + size, y:y + size, x + size:x + 2 * size]
    return t


def _tile_slabs(slabs: list, size: int, broken) -> list:
    """``broken(slab, size, z)`` on the slab of ``slabs`` (one row's, in
    order along D) that holds the whole volume's centre tile, ``z`` the
    tile's plane in that slab; the other slabs as they are."""
    depth = slabs[0].shape[-3]
    z = depth * len(slabs) // 2 // size * size
    k = z // depth
    return [broken(t, size, z - k * depth) if i == k else t for i, t in enumerate(slabs)]


class _TileGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, size, z=None):
        ctx.size, ctx.z = size, z
        return d.view_as(d)

    @staticmethod
    def backward(ctx, g):
        return _tile(g, ctx.size, ctx.z), None, None


@contextmanager
def dgrad_tile_fault(size: int = 8):
    """A planted fault confined to one ``size``³ tile of the block warp's
    gradient by the displacement (kernel B4's output on the card, B4Z's on
    the sharded step, in the slab that holds the centre): the tile at the
    volume's centre holds its neighbour's.  The forward pass, and so every
    loss of the first step, is untouched."""
    from ir_sgmcmc_tpu_torch.engine import vi
    from ir_sgmcmc_tpu_torch.parallel import spatial

    real, real_slabs = vi.warp_block_gather, spatial.warp_block_gather_slabs

    def faulty(vol, d, *args, **kwargs):
        return real(vol, _TileGrad.apply(d, size), *args, **kwargs)

    def faulty_slabs(vols, disps, *args, **kwargs):
        return real_slabs(vols, _tile_slabs(disps, size, _TileGrad.apply), *args, **kwargs)

    vi.warp_block_gather, spatial.warp_block_gather_slabs = faulty, faulty_slabs
    try:
        yield
    finally:
        vi.warp_block_gather, spatial.warp_block_gather_slabs = real, real_slabs


@contextmanager
def seam_fault():
    """A planted fault of the sharding itself: in every halo exchange of
    the sharded step (``halo._exchange_halo_d``), the second slab takes its
    lower halo planes from the wrong neighbour, the third slab's first
    planes (with two slabs, its own).  The one-device step exchanges
    nothing and is untouched."""
    from ir_sgmcmc_tpu_torch.parallel import halo, spatial

    real = halo._exchange_halo_d

    def faulty(xs: list, r: int) -> list:
        out = real(xs, r)
        if len(xs) > 1:
            wrong = xs[2 if len(xs) > 2 else 1][..., :r, :, :].to(out[1].device)
            out[1] = torch.cat([wrong, out[1][..., r:, :, :]], dim=-3)
        return out

    halo._exchange_halo_d = spatial._exchange_halo_d = faulty
    try:
        yield
    finally:
        halo._exchange_halo_d = spatial._exchange_halo_d = real


FAULTS = {"half": half_batch_fault, "half_sample": half_sample_fault, "tile": tile_fault,
          "tile4": lambda: tile_fault(4), "dgrad_tile": dgrad_tile_fault,
          "dgrad_tile4": lambda: dgrad_tile_fault(4), "seam": seam_fault}


class Program:
    """One cell's program objects: ``state`` and ``call()``, one call of the
    entry the window drives (``steps_per_call`` steps).  VI is built with
    the trainer's remat (:func:`vi_remat`); ``remat`` says which.
    ``devices``: one device, or the list of the devices the configuration
    cuts the step over (:func:`spatial_shards`), the first first; ``mesh``
    is then the placement's mesh, else None."""

    def __init__(self, cfg: dict, traffic: dict, inputs: Inputs, devices, fault=None):
        from ir_sgmcmc_tpu_torch.config import Config

        devices = list(devices) if isinstance(devices, (list, tuple)) else [devices]
        device = devices[0]

        config = Config(cfg, make_dirs=False)
        self.loader_args = cfg["data_loader"]["args"]
        self.bundle = bundle = config.build_bundle()
        self.opt_q_v, self.opt_gmm, self.opt_reg = config.build_optimizers(bundle)
        self.tau = config.tau
        self.phase = traffic["phase"]
        self.n_pairs = len(inputs.pairs)
        self.fault = fault
        self.depth = int(self.loader_args["dims"][0])
        self.mesh = self._mesh(devices)
        self.remat = self.phase == "vi" and vi_remat(cfg) and self.mesh is None
        chunk = int(traffic["steps_per_call"])
        fixeds = [f for f, _ in inputs.pairs]
        movings = [m for _, m in inputs.pairs]
        if self.phase == "mcmc":
            self._build_mcmc(traffic, inputs, fixeds, movings, chunk, device)
        elif self.phase == "vi":
            self._build_vi(traffic, inputs, fixeds, movings, chunk, device)
        else:
            raise ValueError(f"unknown phase {self.phase!r}")

    def _mesh(self, devices: list):
        """The trainer's mesh for a step cut over ``devices``, or None on
        one device (``run.load_cell`` holds a cell's cards to its
        configuration's shards)."""
        if len(devices) == 1:
            return None
        from ir_sgmcmc_tpu_torch.parallel import make_mesh

        if self.phase == "mcmc":
            return make_mesh((1, len(devices)), axes=("chain", "space"), devices=devices)
        return make_mesh((len(devices),), axes=("space",), devices=devices)

    def _images(self, fixed: dict, moving: dict) -> tuple:
        """The pair as the step takes it: cut along D over the mesh."""
        if self.mesh is None:
            return fixed, moving
        from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial

        return (shard_images_spatial(fixed, self.mesh, self.depth),
                shard_images_spatial(moving, self.mesh, self.depth))

    def _build_mcmc(self, traffic, inputs, fixeds, movings, chunk, device):
        from ir_sgmcmc_tpu_torch.engine import init_chains, make_mcmc_chunk
        from ir_sgmcmc_tpu_torch.engine.pairs import make_pair_mcmc_chunk, stack_trees
        from ir_sgmcmc_tpu_torch.parallel import shard_state_spatial

        b = self.bundle
        states = []
        for i in range(self.n_pairs):
            s = init_chains(b, torch.Generator(device=device), int(traffic["chains"]), "identity",
                            None, b.gmm.init_params(device), b.reg_loss.init_params(device),
                            self.opt_gmm, self.opt_reg, device=device)
            states.append(s._replace(v=inputs.v0[i].clone(), key=inputs.keys[i].clone()))
        burn_in, thin = int(traffic["burn_in"]), int(traffic["thin"])
        if self.n_pairs == 1:
            self.state = states[0]
            if self.mesh is not None:
                self.state = shard_state_spatial(self.state, self.mesh, int(traffic["chains"]),
                                                 self.depth)
            fixed, moving = self._images(fixeds[0], movings[0])
            run = make_mcmc_chunk(b, self.opt_gmm, self.opt_reg, self.tau, fixed, moving,
                                  chunk=chunk, burn_in=burn_in, thin=thin)
            self._lead = 1
        else:
            self.state = stack_trees(states)
            run = make_pair_mcmc_chunk(b, self.opt_gmm, self.opt_reg, self.tau,
                                       stack_trees(fixeds), stack_trees(movings), chunk=chunk,
                                       burn_in=burn_in, thin=thin)
            self._lead = 2
        self._run = run

    def _build_vi(self, traffic, inputs, fixeds, movings, chunk, device):
        from ir_sgmcmc_tpu_torch.engine import VIState, make_vi_chunk, make_vi_step
        from ir_sgmcmc_tpu_torch.engine.pairs import make_pair_vi_chunk, stack_trees

        b = self.bundle
        sigma_v = float(self.loader_args["sigma_v_init"])
        u_v = float(self.loader_args["u_v_init"])
        states = []
        for i in range(self.n_pairs):
            q_v = b.init_q_v(sigma_v, u_v, device)
            gmm, reg = b.gmm.init_params(device), b.reg_loss.init_params(device)
            s = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=self.opt_q_v.init(q_v),
                        opt_gmm=self.opt_gmm.init(gmm), opt_reg=self.opt_reg.init(reg),
                        key=inputs.keys[i].clone(), step=0)
            states.append(s)
        self.warmup_steps = int(traffic["gmm_warmup_steps"])
        self._warmup_args = (states, fixeds, movings)
        if self.n_pairs == 1:
            fixed, moving = self._images(fixeds[0], movings[0])
            self._run = make_vi_chunk(make_vi_step(b, self.opt_q_v, self.opt_gmm, self.opt_reg,
                                                   fixed, moving, remat=self.remat),
                                      chunk)
            self._lead = 0
        else:
            self._run = make_pair_vi_chunk(b, self.opt_q_v, self.opt_gmm, self.opt_reg,
                                           stack_trees(fixeds), stack_trees(movings), chunk,
                                           remat=self.remat)
            self._lead = 1
        self.state = states[0] if self.n_pairs == 1 else stack_trees(states)

    def gmm_warmup(self):
        """The VI cells' GMM warm-up, pair by pair on the first device, as
        the trainer runs it; a sharded phase then cuts the state."""
        from ir_sgmcmc_tpu_torch.engine import gmm_warmup
        from ir_sgmcmc_tpu_torch.engine.pairs import stack_trees
        from ir_sgmcmc_tpu_torch.parallel import shard_tree_spatial

        states, fixeds, movings = self._warmup_args
        warm = [gmm_warmup(self.bundle, self.opt_gmm, s, f, m, no_steps=self.warmup_steps)
                for s, f, m in zip(states, fixeds, movings)]
        self.state = warm[0] if self.n_pairs == 1 else stack_trees(warm)
        if self.mesh is not None:
            self.state = shard_tree_spatial(self.state, self.mesh, self.depth)

    def call(self):
        """One call of the window's entry; returns the per-step loss of
        every row, ``(steps_per_call, rows)``."""
        if self.fault in FAULTS:
            with FAULTS[self.fault]():
                new, metrics = self._run(self.state)
        else:
            new, metrics = self._run(self.state)
        if self.fault != "unchanged":
            self.state = new
        return self.losses(metrics)

    def losses(self, metrics) -> torch.Tensor:
        if self.phase == "mcmc":
            loss = metrics["data_term"] + metrics["reg_term"]  # (chunk, C) or (P, chunk, C)
            if self._lead == 2:
                loss = loss.transpose(0, 1)
            return loss.reshape(loss.shape[0], -1)
        loss = metrics["total_loss"]  # (chunk,) or (P, chunk)
        return loss.reshape(-1, 1) if self._lead == 0 else loss.transpose(0, 1)

    # ---- the state as rows, for the comparison
    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        if self._lead == 0:
            return t.unsqueeze(0)
        if self._lead == 2:
            return t.reshape((-1,) + tuple(t.shape[2:]))
        return t

    def _copies(self, of) -> dict:
        """``of(tree)``'s tensors as ``(rows, …)`` copies: on the state's
        device, or on the host for a sharded phase; of a placed state, each
        leaf gathered by the cut its placement recorded."""
        if not self._placed():
            host = self.mesh is not None
            return {k: self._rows(t.detach().to("cpu", copy=True) if host else t.detach().clone())
                    for k, t in of(self.state).items()}
        from ir_sgmcmc_tpu_torch.parallel import Sharded, gather
        from ir_sgmcmc_tpu_torch.parallel.mesh import _map

        order = []
        _map(lambda x, host: order.append(id(x)), self.state[0])
        cuts = [self.state.cuts[order.index(id(t))] for t in of(self.state[0]).values()]
        whole = gather(Sharded([of(tree) for tree in self.state], self.state.mesh, cuts), "cpu")
        # a replicated leaf of a state on the host is gathered as itself
        return {k: self._rows(t if cut else t.clone()) for (k, t), cut in zip(whole.items(), cuts)}

    def _placed(self) -> bool:
        """Whether the state is placed over the mesh (a sharded VI state is
        placed after its GMM warm-up)."""
        from ir_sgmcmc_tpu_torch.parallel import Sharded

        return isinstance(self.state, Sharded)

    def leaves(self) -> dict:
        """The parameters the steps move, and (SG-MCMC) the posterior mean
        accumulator, as ``(rows, …)`` copies."""
        def of(s):
            if self.phase == "mcmc":
                out = {"v": s.v, "welford.mean": s.welford.mean}
            else:
                out = {f"q.{k}": t for k, t in s.q_v.items()}
            out.update({f"gmm.{k}": t for k, t in s.gmm.items()})
            if self.bundle.reg_loss.learnable:
                out.update({f"reg.{k}": t for k, t in s.reg.items()})
            return out

        return self._copies(of)

    def first_moments(self) -> dict:
        """Adam's first moments of the optimisers, as rows (after one step
        from zero they are ``(1 - b1)`` times the gradient)."""
        def of(s):
            out = {}
            if self.phase == "mcmc":
                out.update({f"gmm.{k}": t for k, t in s.opt_gmm.mu.items()})
            else:
                out.update({f"q.{k}": t for k, t in s.opt_q_v.mu.items()})
            if self.bundle.reg_loss.learnable:
                out.update({f"reg.{k}": t for k, t in s.opt_reg.mu.items()})
            return out

        return self._copies(of)

    def finite_rows(self) -> torch.Tensor:
        """Whether each row's sampled field is finite (on the host for a
        sharded state: every slab's)."""
        def finite(tree):
            t = self._rows(tree.v if self.phase == "mcmc" else tree.q_v["mu"])
            return torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)

        if not self._placed():
            return finite(self.state)
        return torch.stack([finite(tree).cpu() for tree in self.state]).all(dim=0)
