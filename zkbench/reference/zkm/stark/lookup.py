# Frozen copy of zkm_tpu_torch/stark/lookup.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""In-table logUp range checks (paper ia.cr/2022/1530).

Counterpart of `zkm_tpu/stark/lookup.py` (zkMIPS prover/src/lookup.rs).
Helper columns h_i = sum over a 2-column batch of 1/(challenge + f_i); Z
runs FORWARD (Z(first)=0, Z(gx) = Z(x) + sum h_i(x) - m(x)/(challenge +
t(x))), the opposite direction from the CTL Z.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .columns import Column, Filter
from .cross_table_lookup import GrandProductChallenge, eval_helper_columns


@dataclass(frozen=True)
class Lookup:
    columns: Tuple[Column, ...]
    table_column: Column
    frequencies_column: Column
    filter_columns: Tuple[Optional[Filter], ...]

    def num_helper_columns(self, constraint_degree: int) -> int:
        k = constraint_degree - 1
        return (len(self.columns) + k - 1) // k + 1


# frozen: left out, as only the prover uses them: _prefix_sum_exclusive,
# lookup_helper_columns.


def eval_packed_lookups_generic(algebra, lookups, local, nxt, lookup_local,
                                lookup_next, challenges, constraint_degree,
                                consumer):
    """lookup_local/next: aux-poly openings for the lookup helper block."""
    assert constraint_degree == 3
    start = 0
    for lookup in lookups:
        nh = lookup.num_helper_columns(constraint_degree)
        for challenge in challenges:
            ch = GrandProductChallenge(beta=1, gamma=challenge)
            col_evals = [[c.eval(algebra, local, nxt)]
                         for c in lookup.columns]
            eval_helper_columns(
                algebra, lookup.filter_columns, col_evals, local, nxt,
                lookup_local[start:start + nh - 1], constraint_degree, ch,
                consumer)
            z = lookup_local[start + nh - 1]
            next_z = lookup_next[start + nh - 1]
            table = lookup.table_column.eval(algebra, local, nxt)
            table_ch = algebra.add_scalar(table, challenge)
            y = algebra.zero
            for h in lookup_local[start:start + nh - 1]:
                y = algebra.add(y, h)
            y = algebra.sub(algebra.mul(y, table_ch),
                            lookup.frequencies_column.eval(algebra, local, nxt))
            consumer.constraint_first_row(z)
            consumer.constraint(
                algebra.sub(algebra.mul(algebra.sub(next_z, z), table_ch), y))
            start += nh
