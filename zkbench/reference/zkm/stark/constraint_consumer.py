# Frozen copy of zkm_tpu_torch/stark/constraint_consumer.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Alpha-accumulation of constraints with row-selector weighting.

Copy of zkm_tpu/stark/constraint_consumer.py (zkMIPS
prover/src/constraint_consumer.rs), identical semantics: `constraint` applies on all rows (later divided by Z_H);
`constraint_transition` multiplies by z_last = (x - g^{n-1});
`constraint_first/last_row` multiply by the corresponding Lagrange basis.
Generic over the algebra (the port uses it with host ext scalars in the
verifier; the prover folds constraints with `expr.feed_consumer`).

`constraint_batch` folds k constraints at once —
acc <- acc * alpha^k + sum_i alpha^{k-1-i} c_i — turning k alpha-multiply
chains into one weighted reduction.  Tables use it to keep the compiled
constraint graph small; the accumulation order (and thus the transcript
math) is identical to issuing the k constraints one by one.
"""

from __future__ import annotations

from typing import List


class ConstraintConsumer:
    def __init__(self, algebra, alphas: List, z_last, lagrange_first,
                 lagrange_last):
        self.a = algebra
        self.alphas = alphas          # list of algebra scalars
        self.accs = [algebra.zero for _ in alphas]
        self.z_last = z_last
        self.lagrange_first = lagrange_first
        self.lagrange_last = lagrange_last
        self.count = 0
        self._pow_cache = {}

    def constraint(self, c):
        a = self.a
        self.accs = [a.add(a.mul(acc, alpha), c)
                     for acc, alpha in zip(self.accs, self.alphas)]
        self.count += 1

    def constraint_transition(self, c):
        self.constraint(self.a.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(self.a.mul(c, self.lagrange_first))

    def constraint_last_row(self, c):
        self.constraint(self.a.mul(c, self.lagrange_last))

    # -- batched variants ----------------------------------------------------

    def _alpha_pows(self, j: int, k: int):
        """[alpha_j^0 .. alpha_j^k] (incrementally extended and cached, so
        mixed batch sizes share the power chain)."""
        pows = self._pow_cache.setdefault(j, [self.a.one])
        while len(pows) <= k:
            pows.append(self.a.mul(pows[-1], self.alphas[j]))
        return pows

    def constraint_batch(self, values, k: int):
        """Accumulate k constraints at once (same math as k constraint()s)."""
        if k == 0:
            return
        a = self.a
        new_accs = []
        for j, acc in enumerate(self.accs):
            pows = self._alpha_pows(j, k)
            term = a.weighted_sum(values, pows, k)
            new_accs.append(a.add(a.mul(acc, pows[k]), term))
        self.accs = new_accs
        self.count += k

    def constraint_transition_batch(self, values, k: int):
        self.constraint_batch(self.a.scale_batch(values, self.z_last), k)

    def constraint_first_row_batch(self, values, k: int):
        self.constraint_batch(
            self.a.scale_batch(values, self.lagrange_first), k)

    def constraint_last_row_batch(self, values, k: int):
        self.constraint_batch(
            self.a.scale_batch(values, self.lagrange_last), k)
