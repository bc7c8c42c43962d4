"""Per-step wall times of a proof, with the device drained at each edge.

A `StepTimer` is passed down by the caller that wants the numbers; code
that receives `timer=None` pays nothing.  Each step synchronizes its
device on entry and exit, so a step's time includes the device work it
queued (and the synchronizations cost a few microseconds each).
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch


class StepTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def step(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + time.perf_counter() - t0


def step(timer: Optional[StepTimer], name: str):
    """`timer.step(name)`, or a no-op context when there is no timer."""
    return timer.step(name) if timer is not None else nullcontext()
