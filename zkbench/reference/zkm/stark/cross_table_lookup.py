# Frozen copy of zkm_tpu_torch/stark/cross_table_lookup.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""logUp cross-table lookup engine.

Counterpart of `zkm_tpu/stark/cross_table_lookup.py` (zkMIPS
prover/src/cross_table_lookup.rs): helper columns batch looking
column-sets in chunks of constraint_degree-1 = 2; the CTL Z polynomial is
a *reverse* cumulative sum (Z(row 0) holds the grand total, opened at
point 1); cross-table verification checks sum of looking ctl_zs_first ==
looked ctl_zs_first.

The trace side runs on int64 tensors over whole traces at once (masked
batched inverse, modular suffix sums); the constraint side (`eval_*`) is
generic algebra, copied from the reference.

Over a tp group (`comm`), each rank holds a contiguous block of every
trace's rows plus the next row after it (the halo that next-row columns
read).  Helper columns are row-local; each Z is this block's suffix sum
plus the totals of the blocks after it, all blocks' totals gathered at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..field import goldilocks as gl
from .columns import Column, Filter

P = gl.P


@dataclass(frozen=True)
class GrandProductChallenge:
    """beta/gamma: python ints on the transcript path, or algebra values
    (symbolic PARAM nodes) in the constraint compiler."""
    beta: object
    gamma: object

    def combine_host(self, terms, algebra):
        """reduce_with_powers(terms, beta) + gamma (term 0 lowest power)."""
        acc = algebra.zero
        for t in reversed(list(terms)):
            acc = algebra.add(algebra.mul_scalar(acc, self.beta), t)
        return algebra.add_scalar(acc, self.gamma)

    def combine_all_rows(self, cols: List[torch.Tensor]) -> torch.Tensor:
        acc = torch.zeros_like(cols[0])
        for t in reversed(cols):
            acc = gl.add(gl.mul(acc, self.beta), t)
        return gl.add(acc, self.gamma)


@dataclass
class GrandProductChallengeSet:
    challenges: List[GrandProductChallenge]


def get_grand_product_challenge_set(challenger, num_challenges: int
                                    ) -> GrandProductChallengeSet:
    out = []
    for _ in range(num_challenges):
        beta = challenger.get_challenge()
        gamma = challenger.get_challenge()
        out.append(GrandProductChallenge(beta, gamma))
    return GrandProductChallengeSet(out)


@dataclass(frozen=True)
class TableWithColumns:
    table: int
    columns: Tuple[Column, ...]
    filter: Optional[Filter]


@dataclass(frozen=True)
class CrossTableLookup:
    looking_tables: Tuple[TableWithColumns, ...]
    looked_table: TableWithColumns

    def __post_init__(self):
        n = len(self.looked_table.columns)
        assert all(len(t.columns) == n for t in self.looking_tables)


# frozen: left out, as only the prover uses them: CtlZData, CtlData,
# _suffix_sum, partial_sums, cross_table_lookup_data.


# ---------------------------------------------------------------------------
# Trace-side computation (device, vectorized).
# ---------------------------------------------------------------------------

def _masked_combined(trace: torch.Tensor, columns: Tuple[Column, ...],
                     filt: Optional[Filter],
                     challenge: GrandProductChallenge):
    """Per-row combine(columns)+gamma where filter==1, else 1, plus the
    mask (True where the row participates)."""
    combined = challenge.combine_all_rows(
        [c.eval_all_rows(trace) for c in columns])
    if filt is None:
        return combined, torch.ones_like(combined, dtype=torch.bool)
    mask = filt.eval_all_rows(trace) == 1        # filter == 1 exactly
    return torch.where(mask, combined, 1), mask


def get_helper_cols(trace: torch.Tensor, columns_filters, challenge,
                    constraint_degree: int) -> List[torch.Tensor]:
    """Chunks of (degree-1) column-sets; helper = sum of masked inverses,
    all column-sets inverted as one (k, N) batch."""
    terms = [_masked_combined(trace, cols, filt, challenge)
             for cols, filt in columns_filters]
    inv = gl.inverse(torch.stack([t[0] for t in terms]))        # (k, N)
    masked = torch.where(torch.stack([t[1] for t in terms]), inv, 0)

    batch = constraint_degree - 1
    out = []
    for i in range(0, len(columns_filters), batch):
        acc = masked[i]
        for j in range(i + 1, min(i + batch, len(columns_filters))):
            acc = gl.add(acc, masked[j])
        out.append(acc)
    return out


def block_offsets(totals: torch.Tensor, comm, after: bool) -> torch.Tensor:
    """(K,) this rank's block totals -> (K,) the sums of the totals of
    the blocks after it (or before it) in the tp group, mod p."""
    got = comm.all_gather(totals)                          # (size, K)
    part = got[comm.rank + 1:] if after else got[:comm.rank]
    if part.shape[0] == 0:
        return torch.zeros_like(totals)
    return gl.sum_axis(part, 0)


# ---------------------------------------------------------------------------
# Constraint-side evaluation (generic algebra).
# ---------------------------------------------------------------------------

def build_ctl_check_vars(aux_local, aux_next, num_lookup: int,
                         ctl_structure, chal_values):
    """CtlCheckVars from a static aux-layout description.

    ctl_structure: tuple of (num_helpers, challenge_idx, columns, filters);
    chal_values: list of (beta, gamma) algebra values (traced Gf scalars on
    the device path, symbolic PARAM nodes in the expression compiler)."""
    ctl_vars = []
    total_helpers = sum(s[0] for s in ctl_structure)
    h = num_lookup
    for k, (nh, ci, columns, filters) in enumerate(ctl_structure):
        zi = num_lookup + total_helpers + k
        beta, gamma = chal_values[ci]
        ctl_vars.append(CtlCheckVars(
            helper_columns=aux_local[h:h + nh],
            local_z=aux_local[zi], next_z=aux_next[zi],
            challenge=GrandProductChallenge(beta, gamma),
            columns=list(columns), filters=list(filters)))
        h += nh
    return ctl_vars


@dataclass
class CtlCheckVars:
    helper_columns: List        # algebra values
    local_z: object
    next_z: object
    challenge: GrandProductChallenge
    columns: List[Tuple[Column, ...]]
    filters: List[Optional[Filter]]


def eval_helper_columns(algebra, filters, column_evals, local, nxt,
                        helper_values, constraint_degree, challenge,
                        consumer):
    """Check h_i * prod(combin) == sum of cross-filtered combins.

    column_evals: list of per-column-set lists of algebra values."""
    if not helper_values:
        return
    batch = constraint_degree - 1
    for j in range(0, len(column_evals), batch):
        chunk = column_evals[j:j + batch]
        fs = filters[j:j + len(chunk)]
        h = helper_values[j // batch]
        combins = [challenge.combine_host(c, algebra) for c in chunk]
        fvals = [f.eval(algebra, local, nxt) if f is not None else algebra.one
                 for f in fs]
        if len(chunk) == 2:
            lhs = algebra.mul(algebra.mul(combins[1], combins[0]), h)
            rhs = algebra.add(algebra.mul(fvals[0], combins[1]),
                              algebra.mul(fvals[1], combins[0]))
            consumer.constraint(algebra.sub(lhs, rhs))
        elif len(chunk) == 1:
            consumer.constraint(
                algebra.sub(algebra.mul(combins[0], h), fvals[0]))
        else:
            raise NotImplementedError("constraint degree != 3")


def eval_cross_table_lookup_checks(algebra, local, nxt, ctl_vars,
                                   consumer, constraint_degree: int):
    for v in ctl_vars:
        evals = [[c.eval(algebra, local, nxt) for c in cols]
                 for cols in v.columns]
        eval_helper_columns(algebra, v.filters, evals, local, nxt,
                            v.helper_columns, constraint_degree,
                            v.challenge, consumer)
        if v.helper_columns:
            h_sum = algebra.zero
            for h in v.helper_columns:
                h_sum = algebra.add(h_sum, h)
            consumer.constraint_last_row(algebra.sub(v.local_z, h_sum))
            consumer.constraint_transition(
                algebra.sub(algebra.sub(v.local_z, v.next_z), h_sum))
        elif len(v.columns) > 1:
            combin0 = v.challenge.combine_host(evals[0], algebra)
            combin1 = v.challenge.combine_host(evals[1], algebra)
            f0 = v.filters[0].eval(algebra, local, nxt) \
                if v.filters[0] is not None else algebra.one
            f1 = v.filters[1].eval(algebra, local, nxt) \
                if v.filters[1] is not None else algebra.one
            rhs = algebra.add(algebra.mul(f0, combin1),
                              algebra.mul(f1, combin0))
            prod = algebra.mul(combin0, combin1)
            consumer.constraint_last_row(
                algebra.sub(algebra.mul(prod, v.local_z), rhs))
            consumer.constraint_transition(
                algebra.sub(algebra.mul(
                    prod, algebra.sub(v.local_z, v.next_z)), rhs))
        else:
            combin0 = v.challenge.combine_host(evals[0], algebra)
            f0 = v.filters[0].eval(algebra, local, nxt) \
                if v.filters[0] is not None else algebra.one
            consumer.constraint_last_row(
                algebra.sub(algebra.mul(combin0, v.local_z), f0))
            consumer.constraint_transition(
                algebra.sub(algebra.mul(
                    combin0, algebra.sub(v.local_z, v.next_z)), f0))


def ctl_check_vars_from_proofs(openings_per_table, ctls,
                               ctl_challenges: GrandProductChallengeSet,
                               num_lookup_columns: List[int],
                               num_helper_ctl_columns: List[List[int]],
                               ) -> List[List[CtlCheckVars]]:
    """Split each table's auxiliary openings into per-CTL CtlCheckVars.

    openings_per_table[t] = (aux_local, aux_next) host ext lists.
    num_helper_ctl_columns[i][t]: helpers for CTL i in table t.
    Mirrors CtlCheckVars::from_proofs (cross_table_lookup.rs:892-1000)."""
    num_tables = len(openings_per_table)
    nchal = len(ctl_challenges.challenges)
    total_helpers = [0] * num_tables
    for per_table in num_helper_ctl_columns:
        for t in range(num_tables):
            total_helpers[t] += per_table[t] * nchal
    start_indices = [0] * num_tables
    z_indices = [0] * num_tables
    out = [[] for _ in range(num_tables)]
    for ctl, num_ctls in zip(ctls, num_helper_ctl_columns):
        for challenge in ctl_challenges.challenges:
            seen = []
            for t in ctl.looking_tables:
                if t.table not in seen:
                    seen.append(t.table)
            for table in seen:
                aux_local, aux_next = openings_per_table[table]
                nl = num_lookup_columns[table]
                zi = nl + total_helpers[table] + z_indices[table]
                group = [t for t in ctl.looking_tables if t.table == table]
                hstart = nl + start_indices[table]
                helpers = aux_local[hstart:hstart + num_ctls[table]]
                start_indices[table] += num_ctls[table]
                z_indices[table] += 1
                out[table].append(CtlCheckVars(
                    helper_columns=list(helpers),
                    local_z=aux_local[zi], next_z=aux_next[zi],
                    challenge=challenge,
                    columns=[t.columns for t in group],
                    filters=[t.filter for t in group]))
            lt = ctl.looked_table
            aux_local, aux_next = openings_per_table[lt.table]
            nl = num_lookup_columns[lt.table]
            zi = nl + total_helpers[lt.table] + z_indices[lt.table]
            z_indices[lt.table] += 1
            out[lt.table].append(CtlCheckVars(
                helper_columns=[], local_z=aux_local[zi],
                next_z=aux_next[zi], challenge=challenge,
                columns=[lt.columns], filters=[lt.filter]))
    return out


def num_ctl_helper_columns_by_table(ctls, num_tables: int) -> List[List[int]]:
    """Per CTL: helpers per table (ceil(appearances/2) if appearances>1)."""
    out = []
    for ctl in ctls:
        counts = [0] * num_tables
        per = [0] * num_tables
        for t in ctl.looking_tables:
            counts[t.table] += 1
        for t in range(num_tables):
            if counts[t] > 1:
                per[t] = (counts[t] + 1) // 2
            elif counts[t] == 1:
                per[t] = 0
        out.append(per)
    return out


def verify_cross_table_lookups(ctls, ctl_zs_first: List[List[int]],
                               num_challenges: int):
    """sum of looking tables' ctl_zs_first == looked table's, per challenge."""
    iters = [iter(v) for v in ctl_zs_first]
    for index, ctl in enumerate(ctls):
        seen = []
        for t in ctl.looking_tables:
            if t.table not in seen:
                seen.append(t.table)
        for _ in range(num_challenges):
            looking_sum = sum(next(iters[t]) for t in seen) % P
            looked = next(iters[ctl.looked_table.table]) % P
            if looking_sum != looked:
                raise ValueError(
                    f"cross-table lookup {index} verification failed")
    for it in iters:
        try:
            next(it)
            raise ValueError("unconsumed ctl_zs_first opening")
        except StopIteration:
            pass
