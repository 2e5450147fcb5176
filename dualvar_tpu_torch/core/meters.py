"""Training meters (reference utils/utils.py:163-263)."""

from __future__ import annotations

import time
from collections import OrderedDict, deque


class AverageMeter:
    """Running average + sliding-window local average (reference
    utils/utils.py:163-242)."""

    def __init__(self, name: str = "null", fmt: str = ":.4f", window: int = 5):
        self.name = name
        self.fmt = fmt
        self.window = window
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self._local: deque = deque(maxlen=self.window)
        self.local_avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        if n == 0:
            return
        self.avg = self.sum / self.count
        self._local.append(val)
        self.local_avg = sum(self._local) / len(self._local)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"

    def mini_str(self):
        return f"{self.name} {self.val:{self.fmt[1:]}}"


class ProgressMeter:
    """Per-iteration progress lines (reference utils/utils.py:245-263)."""

    def __init__(self, num_batches: int, meters, prefix: str = "", logger=None):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix
        self.logger = logger

    def display(self, batch: int):
        width = len(str(self.num_batches))
        entries = [f"{self.prefix}[{batch:{width}d}/{self.num_batches}]"]
        entries += [m.mini_str() for m in self.meters]
        line = ". ".join(entries)
        if self.logger:
            self.logger.info(line)
        else:
            print(line)


class MeterBank:
    """Dynamically discovered loss/accuracy meters, keyed by loss prefix —
    the reference's generic multi-loss accounting (pretrain.py:404-445)."""

    def __init__(self):
        self.losses: OrderedDict[str, AverageMeter] = OrderedDict()
        self.accs: OrderedDict[str, AverageMeter] = OrderedDict()

    def loss(self, key: str) -> AverageMeter:
        if key not in self.losses:
            self.losses[key] = AverageMeter(f"{key}_loss", ":.3f")
        return self.losses[key]

    def acc(self, key: str) -> AverageMeter:
        if key not in self.accs:
            self.accs[key] = AverageMeter(f"{key}_acc", ":.3f")
        return self.accs[key]

    def all_meters(self):
        return list(self.losses.values()) + list(self.accs.values())


class Timer:
    """reference utils/utils.py:281-293."""

    def __init__(self):
        self.o = time.time()

    def measure(self, p: int = 1) -> str:
        x = int((time.time() - self.o) / p)
        if x >= 3600:
            return f"{x / 3600:.1f}h"
        if x >= 60:
            return f"{round(x / 60)}m"
        return f"{x}s"
