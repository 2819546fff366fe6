"""CLI entry of the port: register image pairs from a JSON experiment config.

    python -m ir_sgmcmc_tpu_torch.run -c configs/demo/config_synthetic.json
    python -m ir_sgmcmc_tpu_torch.run -c config.json -r saved/<name>/<id>/models/vi_latest.npz
    python -m ir_sgmcmc_tpu_torch.run -c config.json -o "trainer;no_iters_VI=64" --device cpu
    python -m ir_sgmcmc_tpu_torch.run -c config.json --devices cuda:0,cuda:0

The JAX package's ``run.py`` with the same options, plus ``--device`` and
``--devices``: the port runs on every visible CUDA card (the VI-test
draws and ``pair_parallel``'s pairs distributed as the JAX trainer does,
the chains only with ``trainer.distribute`` set true) unless ``--device`` names one
device (``cpu`` for the CPU) or ``--devices`` a list, which may repeat a
device (virtual shards).  Overrides use
the ``;``-separated nested-key syntax, with ``=value`` parsed as JSON when
it parses.  Checkpoints of either package resume here.
"""

from __future__ import annotations

import argparse
import json


def _parse_override(spec: str):
    key_path, _, raw = spec.partition("=")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key_path, value


def main(argv=None):
    parser = argparse.ArgumentParser(description="ir-sgmcmc-tpu registration (PyTorch port)")
    parser.add_argument("-c", "--config", required=True, help="JSON config path")
    parser.add_argument("-r", "--resume", default=None, help="checkpoint (.npz) to resume")
    parser.add_argument("-o", "--override", action="append", default=[],
                        metavar="a;b;c=value", help="nested config override")
    parser.add_argument("--run-id", default=None, help="run directory id (default: timestamp)")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="one device (default: every visible CUDA card)")
    parser.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                        help="comma-separated devices, e.g. cuda:0,cuda:1 or cpu,cpu")
    args = parser.parse_args(argv)

    from .config import Config
    from .trainer import Trainer

    overrides = dict(_parse_override(s) for s in args.override)
    config = Config.from_file(args.config, run_id=args.run_id, overrides=overrides)
    devices = args.devices.split(",") if args.devices else None
    trainer = Trainer(config, resume=args.resume, device=args.device, devices=devices)
    summaries = trainer.run()
    for s in summaries:
        config.logger.info("summary: %s", json.dumps(s, default=float))
    return summaries


if __name__ == "__main__":
    main()
