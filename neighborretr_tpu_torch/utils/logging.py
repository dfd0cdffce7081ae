"""Logger + smoothed meters (↔ neighborretr_tpu/utils/logging.py; the
reference's utils/logger.py + metric_logger.py), single process."""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict


def setup_logger(name: str = "neighborretr_tpu_torch", output_dir: str = "",
                 is_main: bool = True, level=logging.DEBUG) -> logging.Logger:
    """Rank-aware logger: non-main processes log errors only (logger.py:13-55)."""
    logger = logging.getLogger(name)
    for h in logger.handlers:      # close before dropping: a re-setup must
        h.close()                  # not leak the previous run's log.txt fd
    logger.handlers.clear()
    logger.propagate = False
    if not is_main:
        logger.setLevel(logging.ERROR)
        logger.addHandler(logging.NullHandler())
        return logger

    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s",
                            datefmt="%m/%d %H:%M:%S")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Window-smoothed scalar meter (metric_logger.py:15-60)."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        # lower-middle on even windows: torch.median returns the smaller of
        # the two central elements, and the reference meters use it
        # (metric_logger.py:34-37)
        d = sorted(self.deque)
        return d[(len(d) - 1) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """update(**kwargs) meters + formatted join (metric_logger.py:63-137)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in ("meters", "delimiter"):
            raise AttributeError(name)
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())


class JsonlMetricsWriter:
    """Machine-readable training log: one JSON object per display step and
    per evaluation, appended to <output_dir>/metrics.jsonl — the
    monitoring-system counterpart of the human log.txt (the reference has
    console logs only; its requirements list wandb but never import it,
    SURVEY §5).  Append mode, so resumed runs continue the same file."""

    def __init__(self, output_dir: str = "", enabled: bool = True):
        self.path = (os.path.join(output_dir, "metrics.jsonl")
                     if output_dir else None)
        self.enabled = bool(enabled and self.path)
        if self.enabled:
            # library callers may pass their own logger to run_training and
            # skip setup_logger's makedirs — the writer owns its directory
            os.makedirs(output_dir, exist_ok=True)

    def write(self, **fields) -> None:
        if not self.enabled:
            return
        import json
        fields.setdefault("time", round(time.time(), 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")
