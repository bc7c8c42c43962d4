"""check_ctls: explicit multiset oracle for cross-table lookups.

Copy of zkm_tpu/stark/ctl_debug.py (zkMIPS
prover/src/cross_table_lookup.rs:1487-1625: the test-only debug check
that recomputes every CTL as a multiset equality over
the raw traces.  This is the primary bring-up tool for new tables: it names
the first offending tuple instead of just failing a grand-product sum.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np

from ..field import goldilocks as gl
from .columns import Column
from .cross_table_lookup import CrossTableLookup

P = gl.P


def _eval_column(col: Column, trace: np.ndarray) -> np.ndarray:
    """Column over a (C, N) uint64 trace -> (N,) object array mod P."""
    n = trace.shape[1]
    acc = np.full(n, col.constant % P, dtype=object)
    for c, k in col.linear:
        acc = (acc + trace[c].astype(object) * k) % P
    if col.next_linear:
        for c, k in col.next_linear:
            acc = (acc + np.roll(trace[c].astype(object), -1) * k) % P
    return acc


def _eval_filter(filt, trace: np.ndarray) -> np.ndarray:
    n = trace.shape[1]
    if filt is None:
        return np.ones(n, dtype=object)
    acc = np.zeros(n, dtype=object)
    for a, b in filt.products:
        acc = (acc + _eval_column(a, trace) * _eval_column(b, trace)) % P
    for c in filt.constants:
        acc = (acc + _eval_column(c, trace)) % P
    return acc


def _side_multiset(entries, traces) -> Counter:
    ms = Counter()
    for t in entries:
        trace = traces[t.table]
        filt = _eval_filter(t.filter, trace)
        cols = [_eval_column(c, trace) for c in t.columns]
        for r in np.nonzero(filt != 0)[0]:
            f = int(filt[r])
            assert f == 1, f"filter value {f} != 0/1 at row {r}"
            ms[tuple(int(c[r]) for c in cols)] += 1
    return ms


def check_ctls(traces: List[np.ndarray], ctls: Sequence[CrossTableLookup],
               names=None):
    """traces[t]: (C, N) uint64 arrays (raw values, not Gf pairs)."""
    for i, ctl in enumerate(ctls):
        label = names[i] if names else str(i)
        looking = _side_multiset(ctl.looking_tables, traces)
        looked = _side_multiset([ctl.looked_table], traces)
        if looking != looked:
            extra_looking = looking - looked
            extra_looked = looked - looking
            msg = [f"CTL {label} multiset mismatch:"]
            for tup, cnt in list(extra_looking.items())[:5]:
                msg.append(f"  looking-only x{cnt}: "
                           f"{[hex(v) for v in tup]}")
            for tup, cnt in list(extra_looked.items())[:5]:
                msg.append(f"  looked-only x{cnt}: "
                           f"{[hex(v) for v in tup]}")
            msg.append(f"  ({len(extra_looking)} looking-only, "
                       f"{len(extra_looked)} looked-only tuples)")
            raise AssertionError("\n".join(msg))
