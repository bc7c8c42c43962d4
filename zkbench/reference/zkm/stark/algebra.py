# Frozen copy of zkm_tpu_torch/stark/algebra.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Host extension-field algebra for constraint evaluation.

Counterpart of `zkm_tpu/stark/algebra.py`.  Constraint code is written once
against a generic algebra; the verifier evaluates it here on host
(int, int) extension scalars at zeta, and the prover runs it once against
the symbolic algebra (stark/expr.py), so the reference's `BatchAlgebra`
has no counterpart in the port.
"""

from __future__ import annotations

from ..field import goldilocks as gl
from ..field import extension as gl2


class ExtRows(list):
    """Host scalar counterpart of BatchRows (a list with .rng)."""

    def rng(self, a, b):
        return list(self[a:b])


def _listwise(op):
    """Broadcast an ExtAlgebra binary op over list-batches (the host
    counterpart of the (k, M) array batches)."""
    def wrapped(self, a, b):
        a_l, b_l = isinstance(a, list), isinstance(b, list)
        if a_l or b_l:
            if not a_l:
                a = [a] * len(b)
            if not b_l:
                b = [b] * len(a)
            return [op(self, x, y) for x, y in zip(a, b)]
        return op(self, a, b)
    return wrapped


class ExtAlgebra:
    """Values: host (c0, c1) int tuples in GF(p^2); batches are lists."""

    def constant(self, c: int):
        return (c % gl.P, 0)

    zero = property(lambda self: (0, 0))
    one = property(lambda self: (1, 0))

    @_listwise
    def add(self, a, b):
        return ((a[0] + b[0]) % gl.P, (a[1] + b[1]) % gl.P)

    @_listwise
    def sub(self, a, b):
        return ((a[0] - b[0]) % gl.P, (a[1] - b[1]) % gl.P)

    @_listwise
    def mul(self, a, b):
        return gl2.host_mul(a, b)

    def mul_const(self, a, c: int):
        if isinstance(a, list):
            return [self.mul_const(x, c) for x in a]
        return ((a[0] * c) % gl.P, (a[1] * c) % gl.P)

    def add_const(self, a, c: int):
        if isinstance(a, list):
            return [self.add_const(x, c) for x in a]
        return ((a[0] + c) % gl.P, a[1])

    def from_base(self, a: int):
        return (a % gl.P, 0)

    def mul_scalar(self, a, s: int):
        return self.mul_const(a, s)

    def add_scalar(self, a, s: int):
        return self.add_const(a, s)

    # -- batched-constraint support (a batch is a plain list of scalars) ----

    def scalar_powers(self, alpha, k: int):
        pows = [self.one]
        for _ in range(k):
            pows.append(self.mul(pows[-1], alpha))
        return pows

    def weighted_sum(self, values, pows, k: int):
        acc = self.zero
        for i in range(k):
            acc = self.add(acc, self.mul(pows[k - 1 - i], values[i]))
        return acc

    def scale_batch(self, values, s):
        return [self.mul(v, s) for v in values]

    def stack_batch(self, items):
        return list(items)
