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

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

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


class _SymRows:
    def __init__(self, algebra: SymbolicAlgebra, is_next: bool):
        self._a = algebra
        self._next = is_next

    def __getitem__(self, col: int) -> int:
        return self._a.next(col) if self._next else self._a.local(col)

    def rng(self, a: int, b: int):
        return _SymBatch([self[c] for c in range(a, b)])


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


class SymConsumer:
    """Records (kind, expr) in call order; kinds pick the row selector."""
    ALL, TRANSITION, FIRST, LAST = range(4)

    def __init__(self):
        self.constraints: List[Tuple[int, int]] = []

    def constraint(self, c):
        self.constraints.append((self.ALL, c))

    def constraint_transition(self, c):
        self.constraints.append((self.TRANSITION, c))

    def constraint_first_row(self, c):
        self.constraints.append((self.FIRST, c))

    def constraint_last_row(self, c):
        self.constraints.append((self.LAST, c))

    def constraint_batch(self, values, k):
        assert len(values) == k
        for v in values:
            self.constraint(v)

    def constraint_transition_batch(self, values, k):
        for v in values:
            self.constraint_transition(v)

    def constraint_first_row_batch(self, values, k):
        for v in values:
            self.constraint_first_row(v)

    def constraint_last_row_batch(self, values, k):
        for v in values:
            self.constraint_last_row(v)


@dataclass(frozen=True)
class StarkIR:
    """Compiled constraint system: node table + ordered constraints."""
    nodes: Tuple[Tuple, ...]              # (op, a, b)
    constraints: Tuple[Tuple[int, int], ...]   # (kind, node)


def compile_stark(stark) -> StarkIR:
    """Run the stark's own eval_generic once symbolically (no lookups, no
    CTLs); public inputs are PARAM nodes 0..num_public_inputs-1."""
    a = _BatchSymAlgebra()
    lv = _SymRows(a, False)
    nv = _SymRows(a, True)
    consumer = SymConsumer()
    if stark.num_public_inputs:
        stark.eval_generic(a, lv, nv, consumer,
                           [a.param(i) for i in range(stark.num_public_inputs)])
    else:
        stark.eval_generic(a, lv, nv, consumer)
    return StarkIR(nodes=tuple(a.nodes), constraints=tuple(consumer.constraints))


def evaluate_ir(ir: StarkIR, get_local, get_next, consumers_constraint,
                params: Sequence[int] = ()):
    """Evaluate the DAG node by node with Goldilocks ops.

    get_local/get_next: col -> (M,) int64 tensor; params: python ints
    matched by PARAM index; consumers_constraint: (kind, value) callback
    issued in the original constraint order.  Values are tensors, or
    python ints for nodes that depend on constants and params only."""
    vals: List = [None] * len(ir.nodes)
    live = _liveness(ir)

    def binary(fn, host, x, y):
        if isinstance(x, int) and isinstance(y, int):
            return host(x, y) % P
        if isinstance(x, int):
            return fn(gl.full((), x, y.device), y)
        return fn(x, y)

    for i, (op, x, y) in enumerate(ir.nodes):
        if not live[i]:
            continue
        if op == CONST:
            v = x
        elif op == LOCAL:
            v = get_local(x)
        elif op == NEXT:
            v = get_next(x)
        elif op == PARAM:
            v = params[x] % P
        elif op in (ADD, ADDC):
            v = binary(gl.add, int.__add__, vals[x],
                       y if op == ADDC else vals[y])
        elif op == SUB:
            v = binary(gl.sub, int.__sub__, vals[x], vals[y])
        elif op in (MUL, MULC):
            v = binary(gl.mul, int.__mul__, vals[x],
                       y if op == MULC else vals[y])
        else:
            raise ValueError(op)
        vals[i] = v
    for kind, node in ir.constraints:
        consumers_constraint(kind, vals[node])


def _liveness(ir: StarkIR):
    live = [False] * len(ir.nodes)
    stack = [node for _, node in ir.constraints]
    while stack:
        i = stack.pop()
        if live[i]:
            continue
        live[i] = True
        op, x, y = ir.nodes[i]
        if op in (ADD, SUB, MUL):
            stack.append(x)
            stack.append(y)
        elif op in (MULC, ADDC):
            stack.append(x)
    return live


@dataclass(frozen=True)
class Schedule:
    """Level-ordered evaluation plan for a StarkIR."""
    n_slots: int
    const_vals: np.ndarray          # (n_consts,) uint64, slots [0, n_consts)
    local_cols: np.ndarray          # trace cols -> slots [n_consts, +n_local)
    next_cols: np.ndarray
    param_idx: np.ndarray           # param indices -> slots after next_cols
    # per level: list of (op, lhs_idx, rhs_idx_or_consts, out_start)
    levels: Tuple
    constraint_slots: np.ndarray    # (C,) slot of each constraint value
    constraint_kinds: Tuple[int, ...]


def schedule_ir(ir: StarkIR) -> Schedule:
    live = _liveness(ir)
    n = len(ir.nodes)
    level = [0] * n
    for i, (op, x, y) in enumerate(ir.nodes):
        if not live[i]:
            continue
        if op in (ADD, SUB, MUL):
            level[i] = 1 + max(level[x], level[y])
        elif op in (MULC, ADDC):
            level[i] = 1 + level[x]

    # slot assignment: consts, locals, nexts first (level 0), then levels
    slot = [-1] * n
    const_vals, local_cols, next_cols = [], [], []
    for i, (op, x, y) in enumerate(ir.nodes):
        if live[i] and op == CONST:
            slot[i] = len(const_vals)
            const_vals.append(x)
    base = len(const_vals)
    for i, (op, x, y) in enumerate(ir.nodes):
        if live[i] and op == LOCAL:
            slot[i] = base + len(local_cols)
            local_cols.append(x)
    base += len(local_cols)
    for i, (op, x, y) in enumerate(ir.nodes):
        if live[i] and op == NEXT:
            slot[i] = base + len(next_cols)
            next_cols.append(x)
    base += len(next_cols)
    param_idx = []
    for i, (op, x, y) in enumerate(ir.nodes):
        if live[i] and op == PARAM:
            slot[i] = base + len(param_idx)
            param_idx.append(x)
    base += len(param_idx)

    max_level = max(level) if n else 0
    levels = []
    for lv in range(1, max_level + 1):
        chunks = []
        for want in (ADD, SUB, MUL, MULC, ADDC):
            members = [i for i in range(n)
                       if live[i] and level[i] == lv
                       and ir.nodes[i][0] == want]
            if not members:
                continue
            out_start = base
            for i in members:
                slot[i] = base
                base += 1
            lhs = np.array([slot[ir.nodes[i][1]] for i in members],
                           dtype=np.int32)
            if want in (MULC, ADDC):
                rhs = np.array([ir.nodes[i][2] for i in members],
                               dtype=np.uint64)
            else:
                rhs = np.array([slot[ir.nodes[i][2]] for i in members],
                               dtype=np.int32)
            chunks.append((want, lhs, rhs, out_start, len(members)))
        levels.append(tuple(chunks))

    return Schedule(
        n_slots=base,
        const_vals=np.array(const_vals, dtype=np.uint64),
        local_cols=np.array(local_cols, dtype=np.int32),
        next_cols=np.array(next_cols, dtype=np.int32),
        param_idx=np.array(param_idx, dtype=np.int32),
        levels=tuple(levels),
        constraint_slots=np.array([slot[node] for _, node in ir.constraints],
                                  dtype=np.int32),
        constraint_kinds=tuple(k for k, _ in ir.constraints))


def _index(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(device)


def _column(values: np.ndarray, device) -> torch.Tensor:
    """u64 constants -> (k, 1) int64 column for broadcasting over M."""
    vals = np.ascontiguousarray(values, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(vals.copy()).to(device)[:, None]


def evaluate_scheduled(sched: Schedule, trace: torch.Tensor,
                       trace_next: torch.Tensor,
                       params: Sequence[int] = ()) -> torch.Tensor:
    """trace/trace_next: (C, M) int64; params: python ints matched by PARAM
    index.  Returns the (n_constraints, M) constraint values in original
    order.  Each level writes its outputs into their slots of one
    preallocated (n_slots, M) buffer."""
    m = trace.shape[-1]
    dev = trace.device
    buf = torch.empty((sched.n_slots, m), dtype=torch.int64, device=dev)
    o = 0
    nc = len(sched.const_vals)
    buf[o:o + nc] = _column(sched.const_vals, dev)
    o += nc
    for src, cols in ((trace, sched.local_cols), (trace_next, sched.next_cols)):
        buf[o:o + len(cols)] = src.index_select(0, _index(cols, dev))
        o += len(cols)
    if len(sched.param_idx):
        vals = np.array([params[i] % P for i in sched.param_idx],
                        dtype=np.uint64)
        buf[o:o + len(vals)] = _column(vals, dev)
    for chunks in sched.levels:
        for op, lhs, rhs, out_start, count in chunks:
            a = buf.index_select(0, _index(lhs, dev))
            if op in (MULC, ADDC):
                b = _column(rhs, dev)
            else:
                b = buf.index_select(0, _index(rhs, dev))
            if op in (ADD, ADDC):
                r = gl.add(a, b)
            elif op == SUB:
                r = gl.sub(a, b)
            else:
                r = gl.mul(a, b)
            buf[out_start:out_start + count] = r
    return buf.index_select(0, _index(sched.constraint_slots, dev))


def feed_consumer(sched: Schedule, cvals: torch.Tensor, alphas: Sequence[int],
                  selectors) -> List[torch.Tensor]:
    """Fold the (C, M) constraint stack into one accumulator per alpha in
    one vectorized pass: acc_j = sum_i alpha_j^{C-1-i} sel_i c_i, where
    sel_i is the row selector of constraint i's kind (1, z_last,
    lagrange_first, lagrange_last).  Identical math (and transcript) to
    issuing the C constraints one by one into a fresh ConstraintConsumer.

    selectors: (z_last, lagrange_first, lagrange_last), each (M,)."""
    m = cvals.shape[-1]
    c = len(sched.constraint_kinds)
    if c == 0:
        return [cvals.new_zeros(m) for _ in alphas]
    sels = torch.stack([torch.ones_like(selectors[0]), *selectors])
    kinds = _index(np.array(sched.constraint_kinds), cvals.device)
    weighted = gl.mul(cvals, sels.index_select(0, kinds))
    accs = []
    for alpha in alphas:
        pw = _column(np.array([pow(alpha, c - 1 - i, P) for i in range(c)],
                              dtype=np.uint64), cvals.device)
        accs.append(gl.sum_axis(gl.mul(weighted, pw), 0))
    return accs
