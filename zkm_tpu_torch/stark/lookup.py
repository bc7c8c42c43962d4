"""In-table logUp range checks (paper ia.cr/2022/1530).

Counterpart of `zkm_tpu/stark/lookup.py` (zkMIPS prover/src/lookup.rs).
Helper columns h_i = sum over a 2-column batch of 1/(challenge + f_i); Z
runs FORWARD (Z(first)=0, Z(gx) = Z(x) + sum h_i(x) - m(x)/(challenge +
t(x))), the opposite direction from the CTL Z.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..field import goldilocks as gl
from .columns import Column, Filter
from .cross_table_lookup import (GrandProductChallenge, block_offsets,
                                 eval_helper_columns, get_helper_cols)


@dataclass(frozen=True)
class Lookup:
    columns: Tuple[Column, ...]
    table_column: Column
    frequencies_column: Column
    filter_columns: Tuple[Optional[Filter], ...]

    def num_helper_columns(self, constraint_degree: int) -> int:
        k = constraint_degree - 1
        return (len(self.columns) + k - 1) // k + 1


def _prefix_sum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """z[0] = 0, z[i] = sum_{j<i} x[j] (mod p)."""
    scanned = gl.cumsum(x, -1)
    return torch.cat([scanned.new_zeros(1), scanned[:-1]])


def lookup_helper_columns(lookup: Lookup, trace: torch.Tensor, challenge: int,
                          constraint_degree: int,
                          comm=None) -> List[torch.Tensor]:
    """Over a tp group `comm`, trace is this rank's block of rows plus
    its halo row; Z is the block's exclusive prefix sum plus the totals
    of the blocks before it."""
    assert constraint_degree == 3
    sharded = comm is not None and comm.size > 1
    rows = trace.shape[-1] - 1 if sharded else trace.shape[-1]
    ch = GrandProductChallenge(beta=1, gamma=challenge)
    columns_filters = [((c,), f) for c, f in
                       zip(lookup.columns, lookup.filter_columns)]
    helpers = [h[:rows] for h in get_helper_cols(
        trace, columns_filters, ch, constraint_degree)]

    table = lookup.table_column.eval_all_rows(trace)[:rows]
    table_inv = gl.inverse(gl.add(table, challenge))
    freq = lookup.frequencies_column.eval_all_rows(trace)[:rows]

    total = helpers[0]
    for h in helpers[1:]:
        total = gl.add(total, h)
    x = gl.sub(total, gl.mul(freq, table_inv))
    z = _prefix_sum_exclusive(x)
    if sharded:
        block_total = gl.add(z[-1:], x[-1:])
        z = gl.add(z, block_offsets(block_total, comm, after=False))
    return helpers + [z]


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
