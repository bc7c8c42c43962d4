"""Composition of per-point constraint evaluation.

Counterpart of zkm_tpu/stark/vanishing_poly.py (zkMIPS
prover/src/vanishing_poly.rs).  Order matters for
alpha accumulation: (1) the STARK's own constraints, (2) in-table logUp
lookups, (3) cross-table lookup checks.

Two evaluation paths with identical constraint order:
  * `eval_vanishing_poly` — direct evaluation (host verifier at zeta, and
    any generic algebra);
  * `eval_vanishing_scheduled` — prover path: the WHOLE vanishing
    polynomial (stark + lookups + CTLs) is compiled once per
    (stark, aux layout) into a hash-consed level schedule (stark/expr.py)
    with the CTL challenges as runtime parameters; evaluation is O(levels)
    tensor ops over the trace‖aux column stack.
"""

from __future__ import annotations

from functools import lru_cache

from . import expr
from .cross_table_lookup import (build_ctl_check_vars,
                                 eval_cross_table_lookup_checks)
from .lookup import eval_packed_lookups_generic


def eval_vanishing_poly(algebra, stark, local, nxt, lookup_vars, ctl_vars,
                        consumer, publics=()):
    """lookup_vars: None or (lookup_local, lookup_next, challenges).
    publics: per-proof public-input scalars (only for starks with
    num_public_inputs > 0); passed through to eval_generic."""
    if stark.num_public_inputs:
        assert len(publics) == stark.num_public_inputs
        stark.eval_generic(algebra, local, nxt, consumer, publics)
    else:
        stark.eval_generic(algebra, local, nxt, consumer)
    if lookup_vars is not None:
        lookup_local, lookup_next, challenges = lookup_vars
        eval_packed_lookups_generic(
            algebra, stark.lookups(), local, nxt, lookup_local, lookup_next,
            challenges, stark.constraint_degree, consumer)
    if ctl_vars:
        eval_cross_table_lookup_checks(
            algebra, local, nxt, ctl_vars, consumer, stark.constraint_degree)


@lru_cache(maxsize=64)
def compile_vanishing(stark, num_lookup: int, ctl_structure,
                      num_challenges: int) -> "expr.Schedule":
    """Symbolically evaluate the full vanishing polynomial and schedule it.

    Aux columns live at column indices [stark.num_columns, ...); CTL
    challenges are PARAM nodes [beta_0, gamma_0, beta_1, gamma_1, ...].
    Cached: starks hash by type and the structure is a tuple."""

    a = expr._BatchSymAlgebra()
    lv = expr._SymRows(a, False)
    nv = expr._SymRows(a, True)
    consumer = expr.SymConsumer()
    if stark.num_public_inputs:
        # publics are PARAM nodes AFTER the challenge params
        pub_nodes = [a.param(2 * num_challenges + i)
                     for i in range(stark.num_public_inputs)]
        stark.eval_generic(a, lv, nv, consumer, pub_nodes)
    else:
        stark.eval_generic(a, lv, nv, consumer)

    chal_nodes = [(a.param(2 * i), a.param(2 * i + 1))
                  for i in range(num_challenges)]
    base = stark.num_columns
    total_helpers = sum(s[0] for s in ctl_structure)
    num_aux = num_lookup + total_helpers + len(ctl_structure)
    aux_local = [a.local(base + i) for i in range(num_aux)]
    aux_next = [a.next(base + i) for i in range(num_aux)]

    if stark.uses_lookups():
        betas = [c[0] for c in chal_nodes]
        eval_packed_lookups_generic(
            a, stark.lookups(), lv, nv, aux_local[:num_lookup],
            aux_next[:num_lookup], betas, stark.constraint_degree, consumer)

    ctl_vars = build_ctl_check_vars(aux_local, aux_next, num_lookup,
                                    ctl_structure, chal_nodes)
    if ctl_vars:
        eval_cross_table_lookup_checks(a, lv, nv, ctl_vars, consumer,
                                       stark.constraint_degree)

    ir = expr.StarkIR(nodes=tuple(a.nodes),
                      constraints=tuple(consumer.constraints))
    return expr.schedule_ir(ir)


def eval_vanishing_scheduled(stark, num_lookup: int, ctl_structure,
                             full_local, full_next, challenges, alphas,
                             selectors, publics=()):
    """Prover path: full_local/full_next are (C+A, M) stacks of trace and
    aux columns; challenges = [(beta, gamma) ints]; publics = per-proof
    public-input ints (params after the challenges); selectors = (z_last,
    lagrange_first, lagrange_last) over the M points.  Returns one (M,)
    alpha-accumulated constraint sum per alpha."""
    sched = compile_vanishing(stark, num_lookup, ctl_structure,
                              len(challenges))
    params = [v for pair in challenges for v in pair] + list(publics)
    cvals = expr.evaluate_scheduled(sched, full_local, full_next, params)
    return expr.feed_consumer(sched, cvals, alphas, selectors)
