"""Per-step wall times of a proof, with the device drained at each edge,
and leveled logging.

A `StepTimer` is passed down by the caller that wants the numbers; code
that receives `timer=None` pays nothing.  Each step synchronizes its
device on entry and exit, so a step's time includes the device work it
queued (and the synchronizations cost a few microseconds each).
`step(timer, name)` is the port's counterpart of zkm_tpu/utils/timing.py's
`timed` scope: every step of a proof, a shrink or an aggregation lands in
the one timer its caller passed.  `log` is zkm_tpu's leveled stderr log.
"""

from __future__ import annotations

import os
import sys
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


_LEVELS = {"error": 0, "warn": 1, "info": 2, "debug": 3}


def log(level: str, fmt: str, *args) -> None:
    """Print to stderr when `level` is at or below ZKM_LOG (error < warn <
    info < debug; default warn)."""
    if _LEVELS[level] <= _LEVELS.get(
            os.environ.get("ZKM_LOG", "warn").lower(), 1):
        msg = fmt % args if args else fmt
        print(f"[zkm:{level}] {msg}", file=sys.stderr, flush=True)
