"""Symbolic (wire-valued) algebra and challenger for DAG recording.

Copy of zkm_tpu/recursion/symbolic.py over the port's algebra and
challenger.

`RecExtAlgebra` implements the same polymorphic interface as
`stark.algebra.ExtAlgebra` with values = (Wire, Wire) extension pairs, so
`eval_vanishing_poly`, `ConstraintConsumer`, Column/Filter evaluation and
the CTL check-vars machinery run UNCHANGED over the DAG — the recursive
verifier is the native verifier re-executed symbolically (no circuit /
native divergence to test, docs/recursion.md).

`SymChallenger` mirrors iop.challenger.Challenger over wires; duplexing
becomes a Poseidon macro node.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field import goldilocks as gl
from ..field import extension as gl2
from ..hash import poseidon as ps
from ..stark.algebra import ExtAlgebra, _listwise
from .dag import Dag, Wire

P = gl.P
W = gl2.W
RATE = ps.SPONGE_RATE
WIDTH = ps.SPONGE_WIDTH

ExtW = Tuple[Wire, Wire]


class RecExtAlgebra(ExtAlgebra):
    """ExtAlgebra over (Wire, Wire) pairs in GF(p^2); batches are lists."""

    def __init__(self, dag: Dag):
        self.d = dag

    def constant(self, c: int) -> ExtW:
        return (self.d.constant(c), self.d.zero)

    @property
    def zero(self) -> ExtW:
        return (self.d.zero, self.d.zero)

    @property
    def one(self) -> ExtW:
        return (self.d.one, self.d.zero)

    @_listwise
    def add(self, a, b):
        d = self.d
        return (d.add(a[0], b[0]), d.add(a[1], b[1]))

    @_listwise
    def sub(self, a, b):
        d = self.d
        return (d.sub(a[0], b[0]), d.sub(a[1], b[1]))

    @_listwise
    def mul(self, a, b):
        d = self.d
        a0, a1 = a
        b0, b1 = b
        c0 = d.add(d.mul(a0, b0), d.mul_const(d.mul(a1, b1), W))
        c1 = d.add(d.mul(a0, b1), d.mul(a1, b0))
        return (c0, c1)

    def mul_const(self, a, c: int):
        if isinstance(a, list):
            return [self.mul_const(x, c) for x in a]
        d = self.d
        return (d.mul_const(a[0], c), d.mul_const(a[1], c))

    def add_const(self, a, c: int):
        if isinstance(a, list):
            return [self.add_const(x, c) for x in a]
        return (self.d.add_const(a[0], c), a[1])

    def from_base(self, a) -> ExtW:
        """a: Wire (symbolic challenge) or int (protocol constant)."""
        if isinstance(a, Wire):
            return (a, self.d.zero)
        return self.constant(a)

    def mul_scalar(self, a, s):
        """s: Wire (e.g. a CTL beta) or int constant."""
        if isinstance(s, Wire):
            return self.mul(a, (s, self.d.zero))
        return self.mul_const(a, s)

    def add_scalar(self, a, s):
        if isinstance(s, Wire):
            if isinstance(a, list):
                return [self.add_scalar(x, s) for x in a]
            return (self.d.add(a[0], s), a[1])
        return self.add_const(a, s)

    # -- extension helpers beyond the ExtAlgebra interface --------------------

    def mul_base(self, a: ExtW, b: Wire) -> ExtW:
        d = self.d
        return (d.mul(a[0], b), d.mul(a[1], b))

    def neg(self, a: ExtW) -> ExtW:
        d = self.d
        return (d.sub(d.zero, a[0]), d.sub(d.zero, a[1]))

    def inverse(self, a: ExtW, label: str = "ext inverse") -> ExtW:
        """Witness-hinted extension inverse, pinned by a * a^-1 == 1."""
        d = self.d
        i0, i1 = d.hint((a[0], a[1]), 2, _hint_ext_inverse)
        prod = self.mul(a, (i0, i1))
        d.assert_zero(d.sub(prod[0], d.one), f"{label}:re")
        d.assert_zero(prod[1], f"{label}:im")
        return (i0, i1)

    def pow_const(self, a: ExtW, e: int) -> ExtW:
        """a^e for a fixed exponent (square-and-multiply chain)."""
        result = self.one
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return result

    def assert_eq(self, a: ExtW, b: ExtW, label: str = ""):
        self.d.assert_eq(a[0], b[0], f"{label}:re")
        self.d.assert_eq(a[1], b[1], f"{label}:im")


def _hint_ext_inverse(vals: List[int]) -> List[int]:
    inv = gl2.host_inv((vals[0], vals[1]))
    return [inv[0], inv[1]]


class SymChallenger:
    """Duplex-sponge Fiat-Shamir challenger over wires (overwrite mode).

    Exactly mirrors iop.challenger.Challenger; get_grand_product_challenge_set
    and the STARK verifier drive it duck-typed."""

    def __init__(self, dag: Dag):
        self.d = dag
        self.state: List[Wire] = [dag.zero] * WIDTH
        self.input_buffer: List[Wire] = []
        self.output_buffer: List[Wire] = []

    def observe_element(self, e: Wire):
        self.output_buffer.clear()
        self.input_buffer.append(e)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_elements(self, es: Sequence[Wire]):
        for e in es:
            self.observe_element(e)

    def observe_extension(self, e: ExtW):
        self.observe_element(e[0])
        self.observe_element(e[1])

    def observe_extensions(self, es):
        for e in es:
            self.observe_extension(e)

    def observe_cap(self, cap_wires: Sequence[Sequence[Wire]]):
        for row in cap_wires:
            self.observe_elements(row)

    def get_challenge(self) -> Wire:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[Wire]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> ExtW:
        c = self.get_n_challenges(2)
        return (c[0], c[1])

    def compact(self) -> List[Wire]:
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.state)

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = self.d.poseidon(self.state)
        self.output_buffer = list(self.state[:RATE])


# -- symbolic Poseidon-hash helpers (mirror hash/poseidon.py host fns) --------

def sym_hash_no_pad(dag: Dag, values: Sequence[Wire]) -> List[Wire]:
    state = [dag.zero] * WIDTH
    for start in range(0, len(values), RATE):
        chunk = list(values[start:start + RATE])
        state[:len(chunk)] = chunk
        state = dag.poseidon(state)
    return state[:ps.DIGEST]


def sym_hash_or_noop(dag: Dag, values: Sequence[Wire]) -> List[Wire]:
    if len(values) <= ps.DIGEST:
        return list(values) + [dag.zero] * (ps.DIGEST - len(values))
    return sym_hash_no_pad(dag, values)


def sym_two_to_one(dag: Dag, left: Sequence[Wire],
                   right: Sequence[Wire]) -> List[Wire]:
    state = list(left) + list(right) + [dag.zero] * (WIDTH - 2 * ps.DIGEST)
    return dag.poseidon(state)[:ps.DIGEST]
