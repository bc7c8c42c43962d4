# Frozen copy of zkm_tpu_torch/stark/vanishing_poly.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
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

from .cross_table_lookup import eval_cross_table_lookup_checks
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


# frozen: left out, as only the prover uses them: compile_vanishing,
# eval_vanishing_scheduled.

