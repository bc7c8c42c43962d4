# Frozen copy of zkm_tpu_torch/stark/verifier.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Multi-table STARK verifier (host-side, exact arithmetic).

Copy of zkm_tpu/stark/verifier.py (zkMIPS prover/src/verifier.rs +
get_challenges.rs): replays the Fiat-Shamir transcript, checks the quotient
identity at zeta for every table, verifies FRI openings, and finally the
cross-table sums.
"""

from __future__ import annotations

from typing import Sequence

from ..field import goldilocks as gl
from ..field import extension as gl2
from ..fri import oracle as fri_oracle
from ..fri.verifier import verify_fri_proof
from ..iop.challenger import Challenger
from .algebra import ExtAlgebra, ExtRows
from .config import StarkConfig
from .constraint_consumer import ConstraintConsumer
from .cross_table_lookup import (ctl_check_vars_from_proofs,
                                 get_grand_product_challenge_set,
                                 num_ctl_helper_columns_by_table,
                                 verify_cross_table_lookups)
from .proof import AllProof
from .prover import observe_public_values, public_inputs_of
from .vanishing_poly import eval_vanishing_poly

P = gl.P


def _ext(arr_row) -> tuple:
    return (int(arr_row[0]), int(arr_row[1]))


def verify_stark_proof_with_challenges(stark, proof_meta, config,
                                       challenger: Challenger,
                                       ctl_vars, num_lookup_columns: int,
                                       lookup_challenges, publics=()):
    proof = proof_meta.proof
    degree_bits = proof_meta.degree_bits
    n = 1 << degree_bits
    openings = proof.openings
    a = ExtAlgebra()

    challenger.observe_cap(proof.auxiliary_polys_cap)
    alphas = challenger.get_n_challenges(config.num_challenges)
    challenger.observe_cap(proof.quotient_polys_cap)
    zeta = challenger.get_extension_challenge()
    zn = gl2.host_pow(zeta, n)
    if zn == (1, 0):
        raise ValueError("opening point is in the subgroup")
    for batch_vals in openings.fri_batches():
        for c0, c1 in batch_vals:
            challenger.observe_extension((int(c0), int(c1)))

    local = ExtRows(_ext(r) for r in openings.local_values)
    nxt = ExtRows(_ext(r) for r in openings.next_values)
    aux_local = [_ext(r) for r in openings.auxiliary_polys]
    aux_next = [_ext(r) for r in openings.auxiliary_polys_next]

    g = gl.primitive_root_of_unity(degree_bits)
    g_last = gl.host_pow(g, n - 1)
    z_last = a.sub(zeta, a.constant(g_last))
    z_h = a.sub(zn, a.one)
    n_inv = gl.host_inv(n)
    l_first = gl2.host_mul(z_h, gl2.host_inv(
        a.mul_const(a.sub(zeta, a.one), n)))
    l_last = gl2.host_mul(
        gl2.host_mul(z_h, (g_last, 0)),
        gl2.host_inv(a.mul_const(a.sub(zeta, a.constant(g_last)), n)))

    consumer = ConstraintConsumer(
        a, [a.from_base(al) for al in alphas], z_last, l_first, l_last)

    lookup_vars = None
    if stark.uses_lookups():
        lookup_vars = (aux_local[:num_lookup_columns],
                       aux_next[:num_lookup_columns], lookup_challenges)

    # publics stay raw (ints here; wires in the DAG recorder; Gf scalars on
    # device) — eval_generic lifts them with a.from_base per use
    eval_vanishing_poly(a, stark, local, nxt, lookup_vars, ctl_vars, consumer,
                        publics)

    # quotient identity: acc_i == Z_H(zeta) * (q_{i,0} + zeta^n q_{i,1})
    factor = stark.quotient_degree_factor
    quots = [_ext(r) for r in openings.quotient_polys]
    for i, acc in enumerate(consumer.accs):
        chunk = quots[i * factor:(i + 1) * factor]
        red = a.zero
        for q in reversed(chunk):
            red = a.add(a.mul(red, zn), q)
        if a.mul(z_h, red) != acc:
            raise ValueError(f"quotient identity failed for challenge {i}")

    # FRI
    num_columns = stark.num_columns
    num_aux = len(aux_local)
    num_quot = len(quots)
    total_ctl_zs = len(openings.ctl_zs_first)
    zeta_next = gl2.host_mul(zeta, (g, 0))
    batches = [
        fri_oracle.OpeningBatch(point=zeta, ranges=(
            fri_oracle.PolyRange(0, 0, num_columns),
            fri_oracle.PolyRange(1, 0, num_aux),
            fri_oracle.PolyRange(2, 0, num_quot))),
        fri_oracle.OpeningBatch(point=zeta_next, ranges=(
            fri_oracle.PolyRange(0, 0, num_columns),
            fri_oracle.PolyRange(1, 0, num_aux))),
        fri_oracle.OpeningBatch(point=(1, 0), ranges=(
            fri_oracle.PolyRange(1, num_aux - total_ctl_zs, num_aux),)),
    ]
    opening_values = openings.fri_batches()
    alpha = challenger.get_extension_challenge()
    combine = fri_oracle.make_combine_initial(
        batches, opening_values, alpha, degree_bits, config.fri_config)
    caps = [proof.trace_cap, proof.auxiliary_polys_cap,
            proof.quotient_polys_cap]
    verify_fri_proof(proof.opening_proof, combine, caps, degree_bits,
                     challenger, config.fri_config)


def verify_proof(starks: Sequence, all_proof: AllProof, ctls,
                 config: StarkConfig):
    num_tables = len(starks)
    challenger = Challenger()
    for p in all_proof.stark_proofs:
        challenger.observe_cap(p.proof.trace_cap)
    observe_public_values(challenger, all_proof.public_values)
    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    for got, want in zip(ctl_challenges.challenges,
                         all_proof.ctl_challenges.challenges):
        if (got.beta, got.gamma) != (want.beta, want.gamma):
            raise ValueError("ctl challenge mismatch")

    num_lookup_columns = [s.num_lookup_helper_columns(config)
                          for s in starks]
    num_helper_ctl = num_ctl_helper_columns_by_table(ctls, num_tables)
    openings_per_table = []
    for p in all_proof.stark_proofs:
        aux_local = [_ext(r) for r in p.proof.openings.auxiliary_polys]
        aux_next = [_ext(r) for r in p.proof.openings.auxiliary_polys_next]
        openings_per_table.append((aux_local, aux_next))
    ctl_vars_per_table = ctl_check_vars_from_proofs(
        openings_per_table, ctls, ctl_challenges, num_lookup_columns,
        num_helper_ctl)

    for t, (stark, proof_meta) in enumerate(zip(starks,
                                                all_proof.stark_proofs)):
        state = challenger.compact()
        if state != proof_meta.init_challenger_state:
            raise ValueError(f"challenger state mismatch at table {t}")
        lookup_challenges = [c.beta for c in ctl_challenges.challenges] \
            if stark.uses_lookups() else None
        verify_stark_proof_with_challenges(
            stark, proof_meta, config, challenger, ctl_vars_per_table[t],
            num_lookup_columns[t], lookup_challenges,
            public_inputs_of(stark, all_proof.public_values))

    ctl_zs_first = [
        [int(v) for v in p.proof.openings.ctl_zs_first]
        for p in all_proof.stark_proofs]
    verify_cross_table_lookups(ctls, ctl_zs_first, config.num_challenges)
