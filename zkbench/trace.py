"""Reading the traced window's device trace (torch.profiler, CUPTI).

Only device activity is traced (CUPTI through kineto): the host's ops
are not recorded, so the profiler adds little to the host's time, and
the window it traces is the window the host timed.  From the trace:

  * the device's busy seconds: the union of every kernel's, copy's and
    set's interval inside the window (overlapping work counts once);
  * device time and count per kernel name;
  * the idle gaps between busy intervals, each named by the step of
    `system.Spans` the host was in at the gap's middle.

Timestamps are ns since the epoch, the clock of `time.time_ns()`.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


class DeviceTrace:
    """A trace of the card's activity alone, over a `with` block.  Its
    events are read raw (`events()`), never parsed into the profiler's
    Python event tree, which takes minutes at the millions of launches of
    a window."""

    def __enter__(self):
        import torch.autograd.profiler as ap
        self._ap = ap
        self._prof = ap.profile(use_cpu=False, use_device="cuda",
                                use_kineto=True)
        self._prof._prepare_trace()
        self._prof._start_trace()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.results = self._ap._disable_profiler()
        return False

    def events(self):
        """(name, start_ns, end_ns) of each device event of the trace."""
        from torch.autograd import DeviceType
        for e in self.results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                yield e.name(), s, s + e.duration_ns()


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint union of [start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[int, int]], t0: int, t1: int
         ) -> List[Tuple[int, int]]:
    """The idle intervals of [t0, t1) around the merged busy ones."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out


def name_at(spans: List[Tuple[str, int, int]], t: int) -> str:
    """The span covering time t (spans sorted by start, disjoint)."""
    starts = [s for _, s, _ in spans]
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] <= t < spans[i][2]:
        return spans[i][0]
    return "outside_steps"


def summarize(events, t0: int, t1: int,
              spans: List[Tuple[str, int, int]]) -> Dict:
    """busy_s, the device events and time per kernel name, and the ten
    longest idle gaps (named) of the window [t0, t1)."""
    kernels: Dict[str, List[float]] = {}
    inside = []
    n = 0
    for name, s, e in events:
        n += 1
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        inside.append((s, e))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy = merge(inside)
    spans = sorted(spans, key=lambda x: x[1])
    idle = sorted(gaps(busy, t0, t1), key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_events": len(inside),
        "events_outside_window": n - len(inside),
        "kernels": kernels,
        "idle_gaps": [[name_at(spans, (s + e) // 2), (e - s) / 1e9]
                      for s, e in idle],
    }


def read(dt: DeviceTrace, t0: int, t1: int, spans) -> Dict:
    return summarize(dt.events(), t0, t1, spans)
