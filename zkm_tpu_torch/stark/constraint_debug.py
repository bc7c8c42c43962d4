"""Row-level constraint debugger over raw u64 traces.

Copy of zkm_tpu/stark/constraint_debug.py: a development analog of
zkMIPS's `check_constraints` (prover.rs:793-910), but per-constraint
instead of alpha-accumulated: each constraint is evaluated on H with
exact object-int numpy arithmetic and violations are reported with
(constraint index, rows).  Used for table bring-up and tamper tests; the
proving path has its own check (stark/prover.py:check_constraints).
"""

from __future__ import annotations

import traceback
from typing import List

import numpy as np

from ..field import goldilocks as gl

P = gl.P


class NpAlgebra:
    """Object-int numpy arrays mod P."""

    zero = 0
    one = 1

    def constant(self, c: int):
        return c % P

    def add(self, a, b):
        return (a + b) % P

    def sub(self, a, b):
        return (a - b) % P

    def mul(self, a, b):
        return (a * b) % P

    def mul_const(self, a, c: int):
        return (a * (c % P)) % P

    def add_const(self, a, c: int):
        return (a + (c % P)) % P

    def mul_scalar(self, a, s):
        return (a * s) % P

    def add_scalar(self, a, s):
        return (a + s) % P

    def from_base(self, a):
        return a % P


class NpRows:
    def __init__(self, trace_obj: np.ndarray):
        self._t = trace_obj          # (C, N) object

    def __getitem__(self, i):
        return self._t[i]

    def rng(self, a, b):
        return self._t[a:b]

    def __len__(self):
        return self._t.shape[0]


class DebugConsumer:
    """Records every individual constraint with its violating rows."""

    def __init__(self, n: int):
        self.n = n
        self.violations: List[tuple] = []
        self.count = 0

    def _record(self, c, mask_last=False, only_first=False, only_last=False):
        c = np.asarray(c % P)
        if c.ndim == 0:
            c = np.full(self.n, int(c), dtype=object)
        bad = np.nonzero(c)[0]
        if mask_last:
            bad = bad[bad != self.n - 1]
        if only_first:
            bad = bad[bad == 0]
        if only_last:
            bad = bad[bad == self.n - 1]
        if bad.size:
            # capture the call site for quick attribution
            site = next((f for f in reversed(traceback.extract_stack())
                         if "constraints" in f.filename
                         or "tables" in f.filename), None)
            self.violations.append(
                (self.count, bad[:8].tolist(),
                 f"{site.filename.split('/')[-1]}:{site.lineno}"
                 if site else "?"))
        self.count += 1

    def constraint(self, c):
        self._record(c)

    def constraint_transition(self, c):
        self._record(c, mask_last=True)

    def constraint_first_row(self, c):
        self._record(c, only_first=True)

    def constraint_last_row(self, c):
        self._record(c, only_last=True)

    def constraint_batch(self, values, k):
        for i in range(k):
            self.constraint(values[i])

    def constraint_transition_batch(self, values, k):
        for i in range(k):
            self.constraint_transition(values[i])


def check_stark_constraints(stark, trace_u64: np.ndarray,
                            raise_on_error: bool = True, publics=()):
    """trace_u64: (C, N) uint64 raw values; evaluates stark.eval_generic on
    every (row, next-row) pair at once."""
    obj = trace_u64.astype(object)
    n = obj.shape[1]
    lv = NpRows(obj)
    nxt = np.concatenate([obj[:, 1:], obj[:, :1]], axis=1)
    nv = NpRows(nxt)
    consumer = DebugConsumer(n)
    if stark.num_public_inputs:
        stark.eval_generic(NpAlgebra(), lv, nv, consumer, list(publics))
    else:
        stark.eval_generic(NpAlgebra(), lv, nv, consumer)
    if consumer.violations and raise_on_error:
        lines = [f"{len(consumer.violations)} constraint violations "
                 f"(of {consumer.count} constraints):"]
        for idx, rows, site in consumer.violations[:12]:
            lines.append(f"  constraint #{idx} [{site}] rows {rows}")
        raise AssertionError("\n".join(lines))
    return consumer.violations
