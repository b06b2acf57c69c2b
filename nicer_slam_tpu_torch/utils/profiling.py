"""Phase timer (counterpart of nicer_slam_tpu/utils/profiling.py).

Wall-clock per named phase (tracking, mapping, cache); the clock stops
after ``torch.cuda.synchronize()`` when the work ran on a card, so a phase
counts the device work it launched and not only the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
