# Frozen copy of zkm_tpu_torch/stark/columns.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Column linear combinations and row filters for lookups/CTLs.

Copy of zkm_tpu/stark/columns.py (zkMIPS prover/src/cross_table_lookup.rs
`Column`, `Filter`), with `eval_all_rows` on int64 tensors.  A Column is an affine combination of trace columns
(current and next row); a Filter is sum(products of two columns) +
sum(columns), must evaluate to 0/1 per row.

`eval_all_rows` evaluates a Column over the whole trace at once (next-row
values via a cyclic roll).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..field import goldilocks as gl

P = gl.P


@dataclass(frozen=True)
class Column:
    linear: Tuple[Tuple[int, int], ...] = ()        # (col, coeff) this row
    next_linear: Tuple[Tuple[int, int], ...] = ()   # (col, coeff) next row
    constant: int = 0

    # -- constructors --------------------------------------------------------

    @staticmethod
    def single(c: int) -> "Column":
        return Column(linear=((c, 1),))

    @staticmethod
    def singles(cs) -> "list[Column]":
        return [Column.single(c) for c in cs]

    @staticmethod
    def constant_col(k: int) -> "Column":
        return Column(constant=k % P)

    @staticmethod
    def zero() -> "Column":
        return Column()

    @staticmethod
    def one() -> "Column":
        return Column(constant=1)

    @staticmethod
    def linear_combination(pairs) -> "Column":
        return Column.linear_combination_with_constant(pairs, 0)

    @staticmethod
    def linear_combination_with_constant(pairs, constant: int) -> "Column":
        pairs = tuple((c, k % P) for c, k in pairs)
        cols = [c for c, _ in pairs]
        assert len(set(cols)) == len(cols), "duplicate columns"
        return Column(linear=pairs, constant=constant % P)

    @staticmethod
    def le_bits(cs) -> "Column":
        return Column.linear_combination(
            (c, 1 << i) for i, c in enumerate(cs))

    @staticmethod
    def sum_cols(cs) -> "Column":
        return Column.linear_combination((c, 1) for c in cs)

    # -- evaluation ----------------------------------------------------------

    def eval(self, algebra, local: Sequence, next_row: Sequence = None):
        """Evaluate with algebra values for each referenced column."""
        acc = algebra.constant(self.constant)
        for c, k in self.linear:
            acc = algebra.add(acc, algebra.mul_const(local[c], k))
        for c, k in self.next_linear:
            assert next_row is not None
            acc = algebra.add(acc, algebra.mul_const(next_row[c], k))
        return acc

    def eval_all_rows(self, trace: torch.Tensor) -> torch.Tensor:
        """trace: (C, N); returns (N,) values with wrapped next row."""
        n = trace.shape[-1]
        acc = gl.full((n,), self.constant, trace.device)
        for c, k in self.linear:
            acc = gl.add(acc, gl.mul(trace[c], k))
        for c, k in self.next_linear:
            acc = gl.add(acc, gl.mul(torch.roll(trace[c], -1), k))
        return acc


@dataclass(frozen=True)
class Filter:
    products: Tuple[Tuple[Column, Column], ...] = ()
    constants: Tuple[Column, ...] = ()

    @staticmethod
    def new_simple(col: Column) -> "Filter":
        return Filter(constants=(col,))

    @staticmethod
    def new(products, constants) -> "Filter":
        return Filter(products=tuple(products), constants=tuple(constants))

    def eval(self, algebra, local, next_row=None):
        acc = algebra.zero
        for a, b in self.products:
            acc = algebra.add(acc, algebra.mul(
                a.eval(algebra, local, next_row),
                b.eval(algebra, local, next_row)))
        for c in self.constants:
            acc = algebra.add(acc, c.eval(algebra, local, next_row))
        return acc

    def eval_all_rows(self, trace: torch.Tensor) -> torch.Tensor:
        n = trace.shape[-1]
        acc = gl.zeros((n,), trace.device)
        for a, b in self.products:
            acc = gl.add(acc, gl.mul(a.eval_all_rows(trace),
                                     b.eval_all_rows(trace)))
        for c in self.constants:
            acc = gl.add(acc, c.eval_all_rows(trace))
        return acc
