# Frozen copy of zkm_tpu_torch/stark/stark.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Stark base class.

Copy of zkm_tpu/stark/stark.py (the zkMIPS `Stark` trait,
prover/src/stark.rs).  One `eval_generic` implementation serves both the
prover (run once against the symbolic algebra, then evaluated as a level
schedule over the quotient domain) and the host verifier (ExtAlgebra at
zeta).
"""

from __future__ import annotations

from typing import List

from .lookup import Lookup


class Stark:
    """Subclasses define `num_columns`, `eval_generic`, optionally `lookups`.

    Instances are stateless; they hash/compare by type, so compiled
    constraint schedules are shared across instances."""

    num_columns: int = 0
    constraint_degree: int = 3
    # Number of public-input scalars bound into the constraints (boundary
    # constraints against per-proof public values).  Tables with publics
    # implement eval_generic with a trailing `publics` argument; the claim
    # values ride the same PARAM mechanism as the CTL challenges in the
    # prover (stark/expr.py) and are host ints on the verifier.
    num_public_inputs: int = 0

    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(self) is type(other)

    def eval_generic(self, algebra, local, nxt, consumer):
        raise NotImplementedError

    def public_inputs(self, roots_before, roots_after, userdata) -> list:
        """Select this table's public-input scalars from the proof claim
        (roots_before/after: 8 elements each; userdata: 32 elements).
        Generic over element type (ints, traced scalars, or DAG wires)."""
        return []

    def lookups(self) -> List[Lookup]:
        return []

    @property
    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree - 1)

    def num_lookup_helper_columns(self, config) -> int:
        return sum(l.num_helper_columns(self.constraint_degree)
                   for l in self.lookups()) * config.num_challenges

    def uses_lookups(self) -> bool:
        return bool(self.lookups())
