"""Helpers of the per-layer metrics' readers (`metrics/<name>.py`).

A reader takes the traced window (`harness.Traced`) and returns its
metric, or None where it finds nothing to read; the harness then leaves
the metric out of the result line.
"""

from __future__ import annotations

import re
from typing import Optional

from . import roofline


def per_proof(t, *steps: str) -> Optional[float]:
    """Seconds the window spent in `steps` (summed), per segment proof."""
    got = [t.steps[s] for s in steps if s in t.steps]
    if not got or not t.proofs:
        return None
    return sum(got) / t.proofs


def kernel_seconds(t, pattern: str) -> float:
    """Device seconds of the kernels whose profiler name matches."""
    rx = re.compile(pattern)
    return sum(v[1] for k, v in t.kernels.items() if rx.search(k))


def roofline_pct(t, pattern: str, int32_ops: float,
                 nbytes: float) -> Optional[float]:
    """100 x the least time the work needs / the kernels' device time."""
    seconds = kernel_seconds(t, pattern)
    if not int32_ops or not seconds:
        return None
    bound = roofline.bound_s(int32_ops, nbytes, t.kind)
    return None if bound is None else 100.0 * bound / seconds
