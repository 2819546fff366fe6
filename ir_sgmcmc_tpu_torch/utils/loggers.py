"""Logging and experiment tracking (port of ``ir_sgmcmc_tpu/utils/loggers.py``).

1. python logging (console + rotating file), logger ``ir_sgmcmc_tpu_torch``;
2. scalars and figures through a TensorBoard writer that degrades to a JSONL
   event log where ``torch.utils.tensorboard`` cannot be imported (the
   import happens only when tracking is enabled);
3. artifact savers (NIfTI/VTK) live in ``savers.py``.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import threading
import time
from pathlib import Path

LOGGER = "ir_sgmcmc_tpu_torch"


def setup_logging(log_dir, verbosity: int = 2, name: str = LOGGER):
    """Console + rotating-file logging; verbosity 0/1/2 -> WARN/INFO/DEBUG."""
    levels = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}
    level = levels.get(int(verbosity), logging.INFO)

    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()

    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)

    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            log_dir / "info.log", maxBytes=10_000_000, backupCount=5
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """TensorBoard-compatible scalar/figure writer with a JSONL fallback:
    ``set_step``, ``add_scalar``, ``add_figure``, ``add_histogram``,
    ``add_text``."""

    def __init__(self, log_dir, enabled: bool = True):
        self.step = 0
        # tag namespace, e.g. "pair1/"
        self.prefix = ""
        self._tb = None
        self._jsonl = None
        # the JSONL fallback is written from both the main loop and the
        # background artifact-writer thread (deferred ASD/figures)
        self._jsonl_lock = threading.Lock()
        if not enabled or log_dir is None:
            return
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(log_dir))
        except Exception:
            self._jsonl = open(log_dir / "events.jsonl", "a", buffering=1)

    @property
    def has_figures(self) -> bool:
        """True when figures will actually be recorded (TensorBoard backend)."""
        return self._tb is not None

    def set_step(self, step: int):
        self.step = int(step)

    def at_step(self, step=None, prefix=None):
        """Writer view bound to a fixed ``(step, prefix)``, for work deferred
        to the background thread while the main loop moves on."""
        return _BoundWriter(self,
                            self.step if step is None else int(step),
                            self.prefix if prefix is None else prefix)

    def add_scalar(self, tag, value):
        self._emit_scalar(self.prefix + tag, value, self.step)

    def _emit_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._jsonl is not None:
            line = json.dumps({"t": time.time(), "step": step, "tag": tag,
                               "value": float(value)}) + "\n"
            with self._jsonl_lock:
                self._jsonl.write(line)

    def add_figure(self, tag, figure):
        self._emit_figure(self.prefix + tag, figure, self.step)

    def _emit_figure(self, tag, figure, step):
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)
        else:
            self._warn_figures_dropped()

    def add_histogram(self, tag, values):
        self._emit_histogram(self.prefix + tag, values, self.step)

    def _emit_histogram(self, tag, values, step):
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)
        else:
            self._warn_figures_dropped()

    def _warn_figures_dropped(self):
        # one-time notice: the JSONL fallback records scalars/text only
        if not getattr(self, "_figures_warned", False):
            self._figures_warned = True
            logging.getLogger(LOGGER).warning(
                "tensorboard is not available: figures/histograms are being "
                "discarded (scalars still go to events.jsonl)"
            )

    def add_text(self, tag, text):
        tag = self.prefix + tag
        if self._tb is not None:
            self._tb.add_text(tag, text, self.step)
        elif self._jsonl is not None:
            with self._jsonl_lock:
                self._jsonl.write(
                    json.dumps({"t": time.time(), "step": self.step,
                                "tag": tag, "text": text}) + "\n"
                )

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class _BoundWriter:
    """`ScalarWriter` view pinned to one ``(step, prefix)``; see ``at_step``."""

    def __init__(self, writer: ScalarWriter, step: int, prefix: str):
        self._w = writer
        self._step = step
        self._prefix = prefix

    @property
    def has_figures(self) -> bool:
        return self._w.has_figures

    def at_step(self, step=None, prefix=None):
        """Already bound: returns itself so call sites can be uniform."""
        return self

    def add_scalar(self, tag, value):
        self._w._emit_scalar(self._prefix + tag, value, self._step)

    def add_figure(self, tag, figure):
        self._w._emit_figure(self._prefix + tag, figure, self._step)

    def add_histogram(self, tag, values):
        self._w._emit_histogram(self._prefix + tag, values, self._step)
