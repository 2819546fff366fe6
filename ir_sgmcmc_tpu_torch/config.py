"""JSON experiment configs (port of ``ir_sgmcmc_tpu/config.py``).

The reference's ``{"type": ..., "args": ...}`` schema, read as the JAX
package reads it: explicit registries instead of reflection, and the
cross-field wiring in one place (dims -> reg loss / transformation, the
dof-derived hyperprior, the Simpson-2012 Gamma shape/rate of a learnable
L2 weight).  The 17 bundled configs parse here; the dense-SVF ones build
the same hyperparameters as the JAX package (a test holds them to it), and
the SVFFD ones build and run as well.

Run directory: ``<save_dir>/<name>/<run_id>/{log, models, tensors,
samples/{VI,MCMC}, images, fields, grids, norms}``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from .engine.bundle import ModelBundle
from .models.distributions import make_distribution
from .models.gmm import GMM
from .models.reg_loss import RegLossL2, RegLossLogNormal, make_reg_loss
from .models.transformation import make_transformation
from .optim import adam_decay
from .utils.loggers import ScalarWriter, setup_logging
from .utils.metrics import STRUCTURES


class Config:
    """Parsed experiment configuration + run directory tree."""

    def __init__(self, cfg: dict, run_id: str | None = None, make_dirs: bool = True):
        self.cfg = cfg
        self.name = cfg.get("name", "experiment")
        self.structures = dict(STRUCTURES)

        trainer = cfg["trainer"]
        self.run_id = run_id if run_id is not None else time.strftime("%m%d_%H%M%S")
        self.dir = Path(trainer.get("save_dir", "saved")) / self.name / self.run_id
        self.save_dirs = {
            "dir": self.dir,
            "log": self.dir / "log",
            "models": self.dir / "models",
            "tensors": self.dir / "tensors",
            "samples": self.dir / "samples",
            "images": self.dir / "images",
            "fields": self.dir / "fields",
            "grids": self.dir / "grids",
            "norms": self.dir / "norms",
        }
        if make_dirs:
            for p in self.save_dirs.values():
                p.mkdir(parents=True, exist_ok=True)
            (self.dir / "samples" / "VI").mkdir(exist_ok=True)
            (self.dir / "samples" / "MCMC").mkdir(exist_ok=True)
            (self.dir / "config.json").write_text(json.dumps(cfg, indent=4))

        self.logger = setup_logging(
            self.save_dirs["log"] if make_dirs else None,
            trainer.get("verbosity", 1),
        )
        self.writer = ScalarWriter(
            self.save_dirs["log"] if make_dirs else None,
            enabled=trainer.get("tensorboard", False) and make_dirs,
        )

    # ---- loading ----------------------------------------------------------
    @classmethod
    def from_file(cls, path, run_id=None, overrides=None, make_dirs=True):
        """Read a JSON config; ``overrides`` maps ``a;b;c`` key paths to
        values (every key but the last must exist)."""
        cfg = json.loads(Path(path).read_text())
        if overrides:
            for key_path, value in overrides.items():
                node = cfg
                keys = key_path.split(";")
                for k in keys[:-1]:
                    if not isinstance(node, dict) or k not in node:
                        raise KeyError(
                            f"config override {key_path!r}: no such key {k!r} "
                            f"(available: {sorted(node) if isinstance(node, dict) else type(node).__name__})"
                        )
                    node = node[k]
                node[keys[-1]] = value
        return cls(cfg, run_id=run_id, make_dirs=make_dirs)

    def __getitem__(self, key):
        return self.cfg[key]

    def get(self, key, default=None):
        return self.cfg.get(key, default)

    # ---- wiring ------------------------------------------------------------
    @property
    def dims(self) -> tuple:
        return tuple(self.cfg["data_loader"]["args"]["dims"])

    @property
    def dof(self) -> float:
        return 3.0 * float(np.prod(self.dims))

    @property
    def cps(self):
        return self.cfg["transformation_module"]["args"].get("cps")

    def build_dataset(self):
        """Instantiate the data loader block."""
        from .data.dataset import make_dataset

        dl = self.cfg["data_loader"]
        args = dict(dl["args"])
        args["cps"] = self.cps
        args.setdefault("save_dir", self.dir)
        return make_dataset(dl["type"], **args)

    def build_bundle(self) -> ModelBundle:
        cfg = self.cfg
        dims = self.dims

        gmm_args = cfg["data_loss"]["args"]
        assert cfg["data_loss"]["type"] == "GMM", "only the GMM data loss exists"
        gmm = GMM(**gmm_args)

        scale_prior = make_distribution(
            cfg["data_loss_scale_prior"]["type"], **cfg["data_loss_scale_prior"]["args"]
        )
        proportion_prior = make_distribution(
            cfg["data_loss_proportion_prior"]["type"],
            **cfg["data_loss_proportion_prior"]["args"],
        )

        reg_args = dict(cfg["reg_loss"]["args"])
        reg_args["dims"] = dims
        reg_loss = make_reg_loss(cfg["reg_loss"]["type"], **reg_args)

        reg_loc_prior = reg_scale_prior = reg_w_reg_prior = None
        if reg_loss.learnable:
            if isinstance(reg_loss, RegLossLogNormal):
                loc_args = dict(cfg["reg_loss_loc_prior"]["args"])
                loc_args["dof"] = self.dof
                reg_loc_prior = make_distribution(cfg["reg_loss_loc_prior"]["type"], **loc_args)
                reg_scale_prior = make_distribution(
                    cfg["reg_loss_scale_prior"]["type"], **cfg["reg_loss_scale_prior"]["args"]
                )
            elif isinstance(reg_loss, RegLossL2):
                # Simpson 2012 calibration
                shape = 0.5 * self.dof
                w_args = dict(cfg["reg_loss_w_reg_prior"]["args"])
                w_args.update(shape=shape, rate=1.0 / shape)
                reg_w_reg_prior = make_distribution(cfg["reg_loss_w_reg_prior"]["type"], **w_args)

        t_cfg = cfg["transformation_module"]
        transformation = make_transformation(
            t_cfg["type"], dims, cps=t_cfg["args"].get("cps"),
            no_steps=t_cfg["args"].get("no_steps", 12),
            max_disp=t_cfg["args"].get("max_disp", 8),
            use_gather=t_cfg["args"].get("use_gather", False),
            taylor_threshold=t_cfg["args"].get("taylor_threshold", 0.5),
            unroll=t_cfg["args"].get("unroll", None),
            taylor_compositions=t_cfg["args"].get("taylor_compositions", None),
            compute_dtype=t_cfg["args"].get("compute_dtype", None),
        )

        sob = cfg.get("Sobolev_grad", {"enabled": False})
        noise = cfg["trainer"].get("uniform_noise", {"enabled": False})
        bw = cfg["trainer"].get("block_warp", {})

        return ModelBundle(
            dims=dims,
            gmm=gmm,
            scale_prior=scale_prior,
            proportion_prior=proportion_prior,
            reg_loss=reg_loss,
            transformation=transformation,
            reg_loc_prior=reg_loc_prior,
            reg_scale_prior=reg_scale_prior,
            reg_w_reg_prior=reg_w_reg_prior,
            sobolev_s=sob["s"] if sob.get("enabled") else None,
            sobolev_lambda=sob.get("lambda", 0.5),
            uniform_noise_alpha=noise["magnitude"] if noise.get("enabled") else None,
            noise_scheme=noise.get("scheme", "post"),
            block_warp=bool(bw.get("enabled", True)),
            block_radius=int(bw.get("radius", 2)),
            block_size=int(bw.get("block", 8)),
            virtual_decimation=bool(cfg.get("virtual_decimation", False)),
        )

    # ---- optimizers -----------------------------------------------------
    def build_optimizers(self, bundle: ModelBundle):
        """(opt_q_v, opt_gmm, opt_reg) with the reference's per-group lrs."""
        o_q = self.cfg["optimizer_q_v"]["args"]
        opt_q_v = adam_decay(
            {"mu": o_q["lr_mu"], "log_var": o_q["lr_log_var"], "u": o_q["lr_u"]},
            o_q.get("lr_decay", 0.0),
        )

        o_g = self.cfg["optimizer_GMM"]["args"]
        opt_gmm = adam_decay(
            {"log_std": o_g["lr_log_std"], "logits": o_g["lr_logits"]},
            o_g.get("lr_decay", 0.0),
        )

        if bundle.reg_loss.learnable and isinstance(bundle.reg_loss, RegLossLogNormal):
            o_r = self.cfg["optimizer_reg"]["args"]
            opt_reg = adam_decay(
                {"loc": o_r["lr_loc"], "log_scale": o_r["lr_log_scale"]},
                o_r.get("lr_decay", 0.0),
            )
        elif bundle.reg_loss.learnable and isinstance(bundle.reg_loss, RegLossL2):
            o_r = self.cfg["optimizer_reg"]["args"]
            opt_reg = adam_decay(
                {"log_w_reg": o_r["lr_log_w_reg"]}, o_r.get("lr_decay", 0.0)
            )
        else:
            opt_reg = adam_decay(0.0)
        return opt_q_v, opt_gmm, opt_reg

    @property
    def tau(self) -> float:
        """SGLD step size = the SG_MCMC optimizer lr."""
        return float(self.cfg["optimizer_SG_MCMC"]["args"]["lr"])
