"""Plain float32 reference of the timed steps: one SG-MCMC transition of a
chain and one VI iteration of a pair, for the configurations under
``configs/``.

It follows the published model (Grzech et al., MELBA 2021) as the
configuration files state it, in plain PyTorch with autograd and no
custom backward, and imports nothing of the program: the smoothing
kernel, the B-spline spreading weights, the integration plan, the priors'
constants and the optimiser states are worked out here again from the
configuration.  Matrix products run with TF32 off.

The random draws follow the benchmark's key convention: every chain (and
every VI pair) carries two 32-bit key words, and step ``n`` seeds one
``torch.Generator`` on the device with :func:`draw_seed`; the draws are
taken from it in the order the step uses them.

Departures from the published model that the configuration states are the
program's documented numerics, taken over here as the definition of the
step: the scaling-and-squaring integration runs ``no_steps - e``
second-order Taylor squarings of ``v / 2^no_steps`` and then ``2^e - 1``
compositions ``d <- u + d∘(id + u)`` by dimensional splitting (one
two-tap lerp per axis, x then y then z, offsets clipped to ±1), with ``e
= ceil(log2 max_disp)``; the image warp is the exact trilinear warp at
``T + U(-alpha, alpha)`` taken around each 8³ block's rounded mean
displacement, its residual clipped to ±R (``trainer.block_warp.radius``).

With ``recompute`` (a volume that the plain step does not fit on one card
at once) each stage of the forward chain, every Taylor squaring and
composition, the image warp, the local normalisation, the likelihood and
the regulariser's energy, runs under ``torch.utils.checkpoint``
(non-reentrant, so the autograd graph, and every number it gives, is the
plain one's): only each stage's inputs are kept, and its inner tensors are
worked out again in the backward pass.  Every draw is taken before the
stages, from the step's generator, so a recompute draws nothing.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

B1_ADAM = 0.9  # Adam's first-moment decay (the optimiser the configs name)
B2_ADAM = 0.999
EPS_ADAM = 1e-8
BLOCK = 8  # the block edge of the block-gather warp
_GOLDEN = 0x9E3779B97F4A7C15
_SALT = 0xBF58476D1CE4E5B9
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


# ---- the key convention ------------------------------------------------------------

def draw_seed(words, step: int, salt: int = 0) -> int:
    """The seed of step ``step``'s generator from two key words."""
    k0, k1 = (int(w) for w in words)
    return (((k0 << 32) | k1) ^ (step * _GOLDEN) ^ (salt * _SALT)) & 0xFFFFFFFFFFFFFFFF


def generator(words, step: int, device, salt: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(words, step, salt))
    return gen


def uniform(gen, shape, alpha: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device) * (2.0 * alpha) - alpha


@contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- the model as the configuration states it ----------------------------------------

def sobolev_kernel(s: int, lam: float) -> np.ndarray:
    """Middle row of ``(I - λL)^{-1}`` for the (2s+1)-point 1D Laplacian,
    normalised to sum 1."""
    n = 2 * s + 1
    lap = -2.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    row = np.linalg.inv(np.eye(n) - lam * lap)[s]
    return row / row.sum()


def bspline(t: np.ndarray) -> np.ndarray:
    """The cubic B-spline basis."""
    t = np.abs(t)
    return np.where(t < 1.0, 2.0 / 3.0 - t * t + 0.5 * t ** 3,
                    np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))


def spread_matrix(n_dense: int, cps: int) -> np.ndarray:
    """``(n_control, n_dense)``: control point ``i`` sits at voxel ``(i -
    1)·cps``, and voxel ``x`` takes ``Σ_i c_i B(x/cps + 1 - i)``."""
    n_ctrl = int(math.ceil((n_dense - 1) / cps)) + 3
    i = np.arange(n_ctrl)[:, None]
    x = np.arange(n_dense)[None, :]
    return bspline(x / cps + 1.0 - i).astype(np.float32)


class Model:
    """The constants of one configuration file (the reference's JSON);
    ``recompute``: the stages run under recompute."""

    def __init__(self, cfg: dict, device, recompute: bool = False):
        self.device = device
        self.recompute = bool(recompute)
        loader = cfg["data_loader"]["args"]
        self.dims = tuple(int(n) for n in loader["dims"])
        self.sigma_v_init, self.u_v_init = float(loader["sigma_v_init"]), float(loader["u_v_init"])
        self.dof = 3.0 * math.prod(self.dims)
        gmm = cfg["data_loss"]["args"]
        self.K, self.lcc_radius = int(gmm["no_components"]), int(gmm["s"])
        sp = cfg["data_loss_scale_prior"]["args"]
        self.scale_prior = (float(sp["loc"]), math.log(float(sp["scale"])))
        self.dirichlet = float(cfg["data_loss_proportion_prior"]["args"]["alpha"])
        reg = cfg["reg_loss"]
        self.reg_kind = reg["type"]
        if self.reg_kind not in ("RegLoss_LogNormal", "RegLoss_L2"):
            raise ValueError(f"the reference has no {self.reg_kind}")
        if reg["args"].get("diff_op", "GradientOperator") != "GradientOperator":
            raise ValueError("the reference computes the forward-difference energy only")
        self.w_reg = float(reg["args"]["w_reg"])
        self.learnable = bool(reg["args"].get("learnable", False))
        if self.reg_kind == "RegLoss_L2" and self.learnable:
            raise ValueError("the reference has no learnable L2 weight")
        if self.learnable:
            self.loc_prior_w_reg = float(cfg["reg_loss_loc_prior"]["args"]["w_reg"])
            rs = cfg["reg_loss_scale_prior"]["args"]
            self.reg_scale_prior = (float(rs["loc"]), math.log(float(rs["scale"])))
            o = cfg["optimizer_reg"]["args"]
            self.lr_reg = {"loc": o["lr_loc"], "log_scale": o["lr_log_scale"]}
            self.decay_reg = float(o.get("lr_decay", 0.0))
        t = cfg["transformation_module"]
        self.svffd = t["type"] in ("SVFFD_3D", "SVFFD3D")
        if not self.svffd and t["type"] not in ("SVF_3D", "SVF3D"):
            raise ValueError(f"the reference has no {t['type']}")
        targs = t["args"]
        self.no_steps = int(targs.get("no_steps", 12))
        self.max_disp = int(targs.get("max_disp", 8))
        threshold = float(targs.get("taylor_threshold", 0.5))
        self.e = max(0, math.ceil(math.log2(self.max_disp))) if self.max_disp > 1 else 0
        self.no_squarings = self.no_steps - self.e
        if self.max_disp / 2 ** (self.e + 1) > threshold:
            raise ValueError("the reference integrates by Taylor squarings only")
        if self.svffd:
            cps = [int(c) for c in targs["cps"]]
            self.spread = [torch.from_numpy(spread_matrix(n, c)).to(device)
                           for n, c in zip(self.dims, cps)]
            self.field_dims = tuple(m.shape[0] for m in self.spread)
        else:
            self.field_dims = self.dims
        sob = cfg.get("Sobolev_grad", {})
        self.sobolev = (torch.tensor(sobolev_kernel(int(sob["s"]), float(sob.get("lambda", 0.5))),
                                     dtype=torch.float32, device=device)
                        if sob.get("enabled") else None)
        tr = cfg["trainer"]
        noise = tr.get("uniform_noise", {})
        if not noise.get("enabled") or noise.get("scheme", "post") != "post":
            raise ValueError("the reference warps once at T + U(-alpha, alpha) (the 'post' scheme)")
        self.alpha = float(noise["magnitude"])
        self.block_radius = int(tr.get("block_warp", {}).get("radius", 2))
        self.block_bound = int(math.ceil(self.max_disp + self.alpha))
        self.vd = bool(cfg.get("virtual_decimation", False))
        self.tau = float(cfg["optimizer_SG_MCMC"]["args"]["lr"])
        og = cfg["optimizer_GMM"]["args"]
        self.lr_gmm = {"logits": og["lr_logits"], "log_std": og["lr_log_std"]}
        self.decay_gmm = float(og.get("lr_decay", 0.0))
        oq = cfg["optimizer_q_v"]["args"]
        self.lr_q = {"mu": oq["lr_mu"], "log_var": oq["lr_log_var"], "u": oq["lr_u"]}
        self.decay_q = float(oq.get("lr_decay", 0.0))

    def stage(self, fn, *args):
        """``fn(*args)``, under recompute where the model runs so."""
        if not self.recompute:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    # -- parameters at their start
    def gmm_init(self) -> dict:
        z = torch.zeros((self.K,), device=self.device)
        return {"logits": z, "log_std": z.clone()}

    def reg_init(self) -> dict:
        if not self.learnable:
            return {}
        # E[log y] under Gamma(dof/2, w_reg/2), in float32
        loc = torch.digamma(torch.tensor(0.5 * self.dof)) - torch.log(torch.tensor(0.5 * self.w_reg))
        return {"loc": loc.to(self.device), "log_scale": (math.log(4.0) + torch.log(loc)).to(self.device)}

    # -- stencils
    @staticmethod
    def fwd_diff(x, axis):
        """Forward difference, the last difference repeated at the end."""
        d = x.narrow(axis, 1, x.shape[axis] - 1) - x.narrow(axis, 0, x.shape[axis] - 1)
        return torch.cat([d, d.narrow(axis, d.shape[axis] - 1, 1)], dim=axis)

    @staticmethod
    def pad(x, axis, lo, hi):
        """``x`` with its edge planes along ``axis`` repeated ``lo`` and
        ``hi`` times (replicate padding)."""
        n = x.shape[axis]
        return torch.cat([x.narrow(axis, 0, 1)] * lo + [x] + [x.narrow(axis, n - 1, 1)] * hi,
                         dim=axis)

    @classmethod
    def shift(cls, x, off, axis):
        """``x(p + off·e_axis)``, the border replicated (``off`` ±1)."""
        return cls.pad(x, axis, max(-off, 0), max(off, 0)).narrow(axis, max(off, 0), x.shape[axis])

    @classmethod
    def correlate(cls, x, kernel, axis):
        """Correlation with an odd 1D ``kernel`` along ``axis``, replicate
        padding."""
        r = kernel.shape[0] // 2
        xp = cls.pad(x, axis, r, r)
        return sum(kernel[j] * xp.narrow(axis, j, x.shape[axis]) for j in range(kernel.shape[0]))

    def smooth(self, v):
        """Sobolev smoothing forward, the identity backward (the Sobolev
        gradient)."""
        if self.sobolev is None:
            return v
        with torch.no_grad():
            s = v
            for axis in (-3, -2, -1):
                s = self.correlate(s, self.sobolev, axis)
        return s + (v - v.detach())  # exactly s forward, the identity backward

    def dense_velocity(self, v):
        if not self.svffd:
            return v
        md, mh, mw = self.spread
        with no_tf32():
            out = torch.einsum("...dhw,dD->...Dhw", v, md)
            out = torch.einsum("...dhw,hH->...dHw", out, mh)
            return torch.einsum("...dhw,wW->...dhW", out, mw)

    _AXES = ((0, -1), (1, -2), (2, -3))

    def square(self, d):
        """One second-order Taylor squaring."""
        return 2.0 * d + sum(self.fwd_diff(d, ax) * d[:, c:c + 1] for c, ax in self._AXES)

    def compose(self, d, u, uc):
        """One composition ``u + d∘(id + u)`` by dimensional splitting at the
        clipped offsets ``uc``."""
        out = d
        for c, ax in self._AXES:
            w = uc[:, c:c + 1]
            out = out + torch.where(w >= 0, w * (self.shift(out, 1, ax) - out),
                                    -w * (self.shift(out, -1, ax) - out))
        return u + out

    def integrate(self, vel):
        """Displacement ``(B, 3, D, H, W)`` in voxels of the velocity."""
        d = vel / float(2 ** self.no_steps)
        for _ in range(self.no_squarings):
            d = self.stage(self.square, d)
        u = d
        # offsets clipped to ±1, their gradient passed where |u| < 1 only
        uc = torch.where(u.abs() < 1.0, u, torch.clamp(u, -1.0, 1.0).detach())
        for _ in range(2 ** self.e - 1):
            d = self.stage(self.compose, d, u, uc)
        return d

    def block_warp(self, vol, d):
        """``vol (B, D, H, W)`` at ``p + d``, trilinear, taps clamped to the
        volume; ``d`` taken as each 8³ block's rounded mean (clipped to the
        bound) plus a residual clipped to ±R, whose gradient is zero
        where clipped.  The volume is data: no gradient."""
        Bn, _, D, H, W = d.shape
        b = BLOCK
        with torch.no_grad():
            means = d.reshape(Bn, 3, D // b, b, H // b, b, W // b, b).mean(dim=(3, 5, 7))
            m = torch.clamp(torch.round(means), -self.block_bound, self.block_bound)
            m = m.repeat_interleave(b, 2).repeat_interleave(b, 3).repeat_interleave(b, 4)
        r = d - m
        R = self.block_radius
        r = torch.where(r.abs() <= R, r, torch.clamp(r, -R, R).detach())
        dev = d.device
        taps = []
        for c, axis, n in ((2, 0, D), (1, 1, H), (0, 2, W)):
            p = torch.arange(n, device=dev, dtype=torch.float32).view(*[n if a == axis else 1
                                                                       for a in range(3)])
            k = torch.floor(r[:, c].detach())
            t = r[:, c] - k
            lo = p + m[:, c] + k
            taps.append([(torch.clamp(lo, 0, n - 1).long(), 1.0 - t),
                         (torch.clamp(lo + 1.0, 0, n - 1).long(), t)])
        flat = vol.reshape(Bn, -1)
        out = 0.0
        for iz, wz in taps[0]:
            for iy, wy in taps[1]:
                for ix, wx in taps[2]:
                    idx = ((iz * H + iy) * W + ix).reshape(Bn, -1)
                    out = out + wz * wy * wx * torch.gather(flat, 1, idx).reshape(Bn, D, H, W)
        return out

    def lcn(self, im):
        n = 2 * self.lcc_radius + 1
        ones = torch.ones((n,), device=im.device)

        def box(x):
            for axis in (-3, -2, -1):
                x = self.correlate(x, ones, axis)
            return x

        mu = box(im) / n ** 3
        var = box((im - mu) ** 2) / n ** 3
        return (im - mu) / torch.sqrt(var + 1e-10)

    def residual(self, fixed, warped):
        return self.lcn(fixed) - self.lcn(warped)

    # -- likelihood and priors
    def log_pdf(self, gmm, z):
        log_w = torch.log_softmax(gmm["logits"] + 1e-2, -1) - gmm["log_std"] - _LOG_SQRT_2PI
        e = 0.5 * (z[..., None] * torch.exp(-gmm["log_std"])) ** 2
        return torch.logsumexp(log_w - e, dim=-1)

    def nll(self, gmm, z, mask):
        return -torch.sum(torch.where(mask, self.log_pdf(gmm, z), 0.0))

    @staticmethod
    def normal_log_pdf(x, loc, log_scale):
        return -0.5 * ((x - loc) / math.exp(log_scale)) ** 2 - log_scale - _LOG_SQRT_2PI

    def gmm_prior(self, gmm):
        scale = torch.sum(self.normal_log_pdf(gmm["log_std"], *self.scale_prior))
        c = self.dirichlet
        log_p = torch.log_softmax(gmm["logits"] + 1e-2, -1)
        return (scale + torch.sum(log_p * (c - 1.0)) + math.lgamma(self.K * c)
                - self.K * math.lgamma(c))

    @torch.no_grad()
    def vd_alpha(self, gmm, res, mask):
        """Virtual decimation: the lag-1 autocorrelation of the residuals
        rescaled by the mixture's responsibilities."""
        if not self.vd:
            return torch.ones((), device=res.device)
        rm = torch.where(mask, res, 0.0)
        log_w = torch.log_softmax(gmm["logits"] + 1e-2, -1) - gmm["log_std"] - _LOG_SQRT_2PI
        z = rm[..., None] * torch.exp(-gmm["log_std"])
        gamma = torch.softmax(log_w - 0.5 * z ** 2, dim=-1)
        x = torch.where(mask, torch.sum(gamma * z * z, -1), 0.0)
        n = torch.sum(mask)
        var = torch.sum(x * x) / n
        out = 1.0
        for axis in (-1, -2, -3):
            m = x.shape[axis] - 1
            corr = torch.clamp(torch.sum(x.narrow(axis, 0, m) * x.narrow(axis, 1, m)) / n / var,
                               min=1e-12)
            out = out * torch.clamp(-2.0 / math.pi * torch.log(corr), max=1.0)
        return torch.sqrt(out)

    def reg_energy(self, v):
        return sum(torch.sum(self.fwd_diff(v, ax) ** 2) for ax in (-1, -2, -3))

    def reg_terms(self, reg, v_smooth):
        """The regulariser's loss with its hyperpriors (a chain's or a
        sample's), and ``log y``."""
        y = self.stage(self.reg_energy, v_smooth)
        log_y = torch.log(y)
        if self.reg_kind == "RegLoss_L2":
            lw = math.log(self.w_reg)
            return 0.5 * self.w_reg * y - 0.5 * self.dof * lw, log_y, 0.0
        scale = torch.exp(reg["log_scale"])
        loss = (log_y + reg["log_scale"] + 0.5 * ((log_y - reg["loc"]) / scale) ** 2
                + (0.5 * self.dof - 1.0) * log_y)
        return loss, log_y, self.normal_log_pdf(reg["log_scale"], *self.reg_scale_prior)

    def loc_prior(self, log_y):
        """ExpGamma(dof/2, w_reg/2) log-density of the log-energy."""
        shape = torch.tensor(0.5 * self.dof, dtype=torch.float32, device=log_y.device)
        rate = torch.tensor(0.5 * self.loc_prior_w_reg, dtype=torch.float32, device=log_y.device)
        return (shape * torch.log(rate) + (shape - 1.0) * log_y - rate * torch.exp(log_y)
                - torch.lgamma(shape) + log_y)

    # -- Adam with a decaying rate
    @staticmethod
    def adam(params, grads, moments, lrs, decay):
        """One step; ``moments`` ``{"step", "m", "v"}`` is updated in place."""
        step = moments["step"]
        t = step + 1
        out = {}
        for k, g in grads.items():
            m = B1_ADAM * moments["m"].get(k, 0.0) + (1.0 - B1_ADAM) * g
            v = B2_ADAM * moments["v"].get(k, 0.0) + (1.0 - B2_ADAM) * g * g
            moments["m"][k], moments["v"][k] = m, v
            lr = lrs[k] / (1.0 + step * decay)
            out[k] = params[k] - lr / (1.0 - B1_ADAM ** t) * m / (
                torch.sqrt(v) / math.sqrt(1.0 - B2_ADAM ** t) + EPS_ADAM)
        moments["step"] = t
        return out

    def gmm_step(self, gmm, moments, res, mask, alpha):
        p = {k: t.detach().requires_grad_(True) for k, t in gmm.items()}
        with torch.enable_grad():
            loss = self.nll(p, res.detach(), mask) * alpha - self.gmm_prior(p)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        moments["grads"] = grads
        return self.adam(gmm, grads, moments, self.lr_gmm, self.decay_gmm)

    # -- the forward chain of one image pair, over a batch of velocity fields
    def forward(self, fixed, moving, v, unif):
        vs = self.smooth(v)
        disp = self.integrate(self.dense_velocity(vs))
        warped = self.stage(self.block_warp, moving["im"].expand((v.shape[0],) + self.dims),
                            disp + unif)
        return vs, disp, self.stage(self.residual, fixed["im"], warped)


# ---- the steps ---------------------------------------------------------------------

def mcmc_chain(model: Model, fixed: dict, moving: dict, v0: torch.Tensor, words,
               steps: int) -> dict:
    """``steps`` SGLD transitions of one chain from ``v0 (3, *field_dims)``
    (the noise start: preconditioner 1, the GMM and regulariser at their
    initial values), with per-chain GMM and regulariser sets, burn-in 0 and
    thin 1.  Returns each transition's potential, the first transition's
    gradients as the optimisers take them, and the leaves after the last."""
    dev = v0.device
    tau, sigma = model.tau, 1.0
    v = v0.clone()
    gmm, reg = model.gmm_init(), model.reg_init()
    m_gmm = {"step": 0, "m": {}, "v": {}}
    m_reg = {"step": 0, "m": {}, "v": {}}
    count, mean = 0, torch.zeros((3,) + model.dims, device=dev)
    losses, first = [], {}
    mask = fixed["mask"]
    for n in range(steps):
        gen = generator(words, n, dev)
        eps = torch.randn((3,) + model.field_dims, generator=gen, device=dev)
        unif = uniform(gen, (3,) + model.dims, model.alpha, dev)
        v_noised = (v + math.sqrt(2.0 * tau) * sigma * eps).requires_grad_(True)
        reg_p = {k: t.detach().requires_grad_(True) for k, t in reg.items()}
        with torch.enable_grad():
            vs, disp, res = model.forward(fixed, moving, v_noised[None], unif[None])
            res = res[0]
            alpha = model.vd_alpha(gmm, res, mask)
            gmm = model.gmm_step(gmm, m_gmm, res, mask, alpha)
            data = model.stage(model.nll, gmm, res, mask) * alpha - model.gmm_prior(gmm)
            reg_loss, log_y, scale_prior = model.reg_terms(reg_p, vs[0])
            if model.learnable:
                reg_loss = reg_loss - model.loc_prior(log_y) - scale_prior
            potential = data + reg_loss
            grads = torch.autograd.grad(potential, [v_noised] + list(reg_p.values()))
        g_v, g_reg = grads[0], dict(zip(reg_p, grads[1:]))
        v = (v_noised - tau * sigma ** 2 * g_v).detach()
        if model.learnable:
            reg = model.adam(reg, g_reg, m_reg, model.lr_reg, model.decay_reg)
        count += 1
        mean = mean + (disp[0].detach() - mean) / count
        losses.append(potential.detach())
        if n == 0:
            first = {"v": g_v, **{f"gmm.{k}": g for k, g in m_gmm["grads"].items()},
                     **{f"reg.{k}": g for k, g in g_reg.items()}}
    leaves = {"v": v, **{f"gmm.{k}": t for k, t in gmm.items()},
              **{f"reg.{k}": t for k, t in reg.items()}, "welford.mean": mean}
    return {"losses": torch.stack(losses), "first": {k: t.detach() for k, t in first.items()},
            "leaves": {k: t.detach() for k, t in leaves.items()}}


def mcmc_noise(model: Model, words, step: int, device):
    """The Langevin draw ``eps`` of a chain's transition ``step`` (the
    first draw of its generator)."""
    gen = generator(words, step, device)
    return torch.randn((3,) + model.field_dims, generator=gen, device=device)


def vi_pair(model: Model, fixed: dict, moving: dict, words, steps: int,
            warmup_steps: int) -> dict:
    """The GMM warm-up and ``steps`` VI iterations of one pair on the
    ``"post"`` scheme, from q(v) at the configuration's start.  Returns each
    iteration's loss, the first iteration's gradients of q(v) and the
    regulariser, and the leaves after the last (the GMM's after the
    warm-up and the iterations)."""
    dev = fixed["im"].device
    mask = fixed["mask"]
    shape = (3,) + model.field_dims
    q = {"mu": torch.zeros(shape, device=dev),
         "log_var": torch.full(shape, 2.0 * math.log(model.sigma_v_init), device=dev),
         "u": torch.full(shape, model.u_v_init, device=dev)}
    gmm, reg = model.gmm_init(), model.reg_init()
    m_gmm = {"step": 0, "m": {}, "v": {}}
    m_q = {"step": 0, "m": {}, "v": {}}
    m_reg = {"step": 0, "m": {}, "v": {}}

    # the GMM warm-up: one draw, scales spread over the residual's spread
    gen = generator(words, 0, dev, salt=1)
    eps = torch.randn(shape, generator=gen, device=dev)
    x = torch.randn((), generator=gen, device=dev)
    unif = uniform(gen, (1, 3) + model.dims, model.alpha, dev)
    words = torch.randint(0, 2 ** 32, (2,), generator=gen, dtype=torch.int64, device=dev).tolist()
    with torch.no_grad():
        v = q["mu"] + eps * torch.exp(0.5 * q["log_var"]) + x * q["u"]
        res = model.forward(fixed, moving, v[None], unif)[2][0]
    n = torch.sum(mask)
    mean = torch.sum(torch.where(mask, res, 0.0)) / n
    sd = torch.sqrt(torch.sum(torch.where(mask, (res - mean) ** 2, 0.0)) / (n - 1))
    lo, hi = torch.log(sd / 100.0), torch.log(sd * 5.0)
    gmm = {**gmm, "log_std": lo + (hi - lo) * torch.arange(model.K, device=dev) / max(model.K - 1, 1)}
    alpha = model.vd_alpha(gmm, res, mask)
    for _ in range(warmup_steps):
        gmm = model.gmm_step(gmm, m_gmm, res, mask, alpha)

    losses, first = [], {}
    for step in range(steps):
        gen = generator(words, step, dev)
        eps = torch.randn(shape, generator=gen, device=dev)
        x = torch.randn((), generator=gen, device=dev)
        unif = uniform(gen, (2, 3) + model.dims, model.alpha, dev)
        qp = {k: t.detach().requires_grad_(True) for k, t in q.items()}
        reg_p = {k: t.detach().requires_grad_(True) for k, t in reg.items()}
        with torch.enable_grad():
            sigma = torch.exp(0.5 * qp["log_var"])
            delta = eps * sigma + x * qp["u"]
            v = torch.stack([qp["mu"] + delta, qp["mu"] - delta])
            vs, _, res = model.forward(fixed, moving, v, unif)
            datas = []
            for i in range(2):
                a = model.vd_alpha(gmm, res[i], mask)
                gmm = model.gmm_step(gmm, m_gmm, res[i], mask, a)
                datas.append(model.stage(model.nll, gmm, res[i], mask) * a)
            data = 0.5 * (datas[0] + datas[1]) - model.gmm_prior(gmm)
            regs = [model.reg_terms(reg_p, vs[i]) for i in range(2)]
            reg_term = 0.5 * (regs[0][0] + regs[1][0])
            if model.learnable:
                reg_term = (reg_term - 0.5 * (model.loc_prior(regs[0][1]) + model.loc_prior(regs[1][1]))
                            - regs[0][2])
            un = qp["u"] / sigma
            un2 = torch.sum(un * un)
            ents = []
            for i in range(2):
                sn = (v[i] - qp["mu"]) / sigma
                ents.append(0.5 * (torch.sum(sn * sn) - torch.sum(sn * un) ** 2 / (1.0 + un2)))
            entropy = 0.5 * (ents[0] + ents[1]) + 0.5 * (torch.log1p(un2) + torch.sum(qp["log_var"]))
            loss = data + reg_term - entropy
            wrt = list(qp.values()) + list(reg_p.values())
            grads = dict(zip(list(qp) + [f"reg.{k}" for k in reg_p], torch.autograd.grad(loss, wrt)))
        q = model.adam(q, {k: grads[k] for k in q}, m_q, model.lr_q, model.decay_q)
        if model.learnable:
            reg = model.adam(reg, {k: grads[f"reg.{k}"] for k in reg}, m_reg, model.lr_reg,
                             model.decay_reg)
        losses.append(loss.detach())
        if step == 0:
            first = {f"q.{k}": grads[k] for k in q}
            first.update({k: g for k, g in grads.items() if k.startswith("reg.")})
    leaves = {**{f"q.{k}": t for k, t in q.items()}, **{f"gmm.{k}": t for k, t in gmm.items()},
              **{f"reg.{k}": t for k, t in reg.items()}}
    return {"losses": torch.stack(losses), "first": {k: t.detach() for k, t in first.items()},
            "leaves": {k: t.detach() for k, t in leaves.items()}}
