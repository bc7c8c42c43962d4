# Frozen copy of zkm_tpu_torch/stark/expr.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Symbolic constraint IR with hash-consing + CSE, and its scheduled
evaluation on int64 tensors.

Counterpart of `zkm_tpu/stark/expr.py`.  `eval_generic` runs ONCE against
`SymbolicAlgebra`, producing a hash-consed DAG: every subexpression is
interned, so shared structure (bit recompositions, partial sums) evaluates
once.  `schedule_ir` (host numpy, copied from the reference) layers the
DAG; `evaluate_scheduled` then evaluates it level by level over a
(slots, M) buffer with one `index_select` per operand and one field op per
(level, op kind).  `evaluate_ir` is the unscheduled evaluator, node by
node, for the checkers (stark/stark_testing.py).  The constraint *order*,
which fixes the verifier's alpha weights, is preserved exactly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..field import goldilocks as gl

P = gl.P

# node ops
LOCAL, NEXT, CONST, ADD, SUB, MUL, MULC, ADDC, PARAM = range(9)


class Node(int):
    """A hash-consed expression node id (distinct from plain int scalars)."""
    __slots__ = ()


class SymbolicAlgebra:
    """Algebra producing hash-consed Expr node ids."""

    def __init__(self):
        self.nodes: List[Tuple] = []      # (op, a, b) with ints
        self._intern: Dict[Tuple, int] = {}
        self._const: Dict[int, int] = {}
        self.zero = self.constant(0)
        self.one = self.constant(1)

    def _mk(self, key: Tuple) -> int:
        idx = self._intern.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(key)
            self._intern[key] = idx
        return Node(idx)

    def node_const(self, idx: int):
        """Constant value of node idx, or None."""
        n = self.nodes[idx]
        return n[1] if n[0] == CONST else None

    def constant(self, c: int) -> int:
        return self._mk((CONST, c % P, 0))

    def local(self, col: int) -> int:
        return self._mk((LOCAL, col, 0))

    def next(self, col: int) -> int:
        return self._mk((NEXT, col, 0))

    def param(self, i: int) -> int:
        return self._mk((PARAM, i, 0))

    def add(self, a: int, b: int) -> int:
        ca, cb = self.node_const(a), self.node_const(b)
        if ca is not None and cb is not None:
            return self.constant(ca + cb)
        if ca == 0:
            return b
        if cb == 0:
            return a
        if cb is not None:
            return self._mk((ADDC, a, cb))
        if ca is not None:
            return self._mk((ADDC, b, ca))
        if a > b:
            a, b = b, a
        return self._mk((ADD, a, b))

    def sub(self, a: int, b: int) -> int:
        cb = self.node_const(b)
        if cb is not None:
            return self.add(a, self.constant(-cb))
        ca = self.node_const(a)
        if ca == 0:
            return self.mul_const(b, P - 1)
        return self._mk((SUB, a, b))

    def mul(self, a: int, b: int) -> int:
        ca, cb = self.node_const(a), self.node_const(b)
        if ca is not None and cb is not None:
            return self.constant(ca * cb)
        if ca is not None:
            return self.mul_const(b, ca)
        if cb is not None:
            return self.mul_const(a, cb)
        if a > b:
            a, b = b, a
        return self._mk((MUL, a, b))

    def mul_const(self, a: int, c: int) -> int:
        c %= P
        ca = self.node_const(a)
        if ca is not None:
            return self.constant(ca * c)
        if c == 0:
            return self.zero
        if c == 1:
            return a
        return self._mk((MULC, a, c))

    def add_const(self, a: int, c: int) -> int:
        return self.add(a, self.constant(c))

    def mul_scalar(self, a, s):
        if isinstance(s, Node):
            return self.mul(a, s)
        return self.mul_const(a, s)

    def add_scalar(self, a, s):
        if isinstance(s, Node):
            return self.add(a, s)
        return self.add_const(a, s)

    def from_base(self, a):
        return a


# frozen: left out, as only the prover uses them: _SymRows, SymConsumer,
# StarkIR, compile_stark, evaluate_ir, _liveness, Schedule, schedule_ir,
# _index, _column, evaluate_scheduled, feed_consumer.


class _SymBatch(list):
    """A list of node ids standing in for a (k, M) batch."""


# batched-consumer support on the symbolic algebra: operate elementwise
def _listwise_sym(algebra, op, a, b):
    a_l, b_l = isinstance(a, list), isinstance(b, list)
    if a_l or b_l:
        if not a_l:
            a = [a] * len(b)
        if not b_l:
            b = [b] * len(a)
        return _SymBatch(op(x, y) for x, y in zip(a, b))
    return op(a, b)


class _BatchSymAlgebra(SymbolicAlgebra):
    pass


for _name in ("add", "sub", "mul"):
    def _wrap(name):
        base = getattr(SymbolicAlgebra, name)

        def fn(self, a, b):
            return _listwise_sym(self, lambda x, y: base(self, x, y), a, b)
        return fn
    setattr(_BatchSymAlgebra, _name, _wrap(_name))


def _batch_mul_const(self, a, c):
    if isinstance(a, list):
        return _SymBatch(SymbolicAlgebra.mul_const(self, x, c) for x in a)
    return SymbolicAlgebra.mul_const(self, a, c)


_BatchSymAlgebra.mul_const = _batch_mul_const

