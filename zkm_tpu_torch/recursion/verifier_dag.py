"""Record the multi-table STARK verifier as an arithmetic DAG (stage R1).

Copy of zkm_tpu/recursion/verifier_dag.py (analog of zkMIPS
prover/src/recursive_verifier.rs:203-307 `recursive_stark_circuit` +
fixed_recursive_verifier.rs:497-611, the root circuit), but fused: ONE
recorded DAG verifies the whole AllProof
(challenger replay across tables, per-table quotient identity at zeta, FRI
queries with Merkle paths, and the cross-table lookup sum check), so there
is no challenger-state chaining across separate circuits.

The recorder re-runs `stark.verifier.verify_proof`'s exact logic over
symbolic wires:

  * proof fields  -> public-input wires (`reflect_proof`, layout =
                     stark/proof.py:flatten_proof);
  * field math    -> DAG add/sub/mul (inverses witness-hinted + pinned);
  * Poseidon      -> permutation macro nodes (CTL rows in stage R2);
  * data-dependent indexing (FRI query paths) -> bit decomposition of the
    drawn challenge + select/mux trees — fixed shape, data-only variance;
  * `raise ValueError` -> `assert_zero` nodes.

`eval_vanishing_poly`, `ConstraintConsumer`, Column/Filter and the CTL
check-vars machinery are reused UNCHANGED via `RecExtAlgebra` — the
constraint logic cannot diverge between the native and recursive verifier.

Shapes (degree bits, column counts, FRI structure) come from a template
proof; the DAG verifies any proof of the same shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..field import goldilocks as gl
from ..fri.config import FriConfig
from ..hash import poseidon as ps
from ..stark.algebra import ExtRows
from ..stark.config import StarkConfig
from ..stark.constraint_consumer import ConstraintConsumer
from ..stark.cross_table_lookup import (ctl_check_vars_from_proofs,
                                        get_grand_product_challenge_set,
                                        num_ctl_helper_columns_by_table)
from ..stark.proof import (AllProof, WAllProof, WFriProof, WOpenings,
                           WStarkProof, walk_proof)
from ..stark.vanishing_poly import eval_vanishing_poly
from .dag import Dag, Wire
from .symbolic import (RecExtAlgebra, SymChallenger, sym_hash_or_noop,
                       sym_two_to_one)

P = gl.P
_INV2 = (P + 1) // 2
DIGEST = ps.DIGEST


# --------------------------------------------------------------------------
# Proof reflection: the proof's scalars as public-input wires, in
# stark/proof.py:walk_proof's order (the order flatten_proof gives values).
# --------------------------------------------------------------------------

def reflect_proof(dag: Dag, template: AllProof) -> WAllProof:
    return walk_proof(template, lambda v: dag.pub_input())


# --------------------------------------------------------------------------
# Symbolic FRI verification (mirrors fri/verifier.py over wires)
# --------------------------------------------------------------------------

def _sym_verify_merkle(dag: Dag, leaf_wires, idx_bits, siblings, cap_wires,
                       label: str):
    digest = sym_hash_or_noop(dag, leaf_wires)
    for lvl, sib in enumerate(siblings):
        b = idx_bits[lvl]
        left = dag.select_vec(b, sib, digest)
        right = dag.select_vec(b, digest, sib)
        digest = sym_two_to_one(dag, left, right)
    nbits = len(cap_wires).bit_length() - 1
    cap_bits = idx_bits[len(siblings):len(siblings) + nbits]
    assert len(cap_wires) == 1 << len(cap_bits), "cap/index shape mismatch"
    row = dag.mux(cap_bits, cap_wires)
    for i in range(DIGEST):
        dag.assert_eq(digest[i], row[i], f"{label}:cap{i}")


def _pow_w_of_bits(dag: Dag, bits_rev_exps, log_n: int):
    """prod_k select(bit_k, w^(2^e_k), 1) for (bit, e_k) pairs over the
    2^log_n-th root of unity w."""
    w = gl.primitive_root_of_unity(log_n)
    acc = dag.one
    for bit, e in bits_rev_exps:
        factor = dag.constant(pow(w, 1 << e, P))
        acc = dag.mul(acc, dag.select(bit, factor, dag.one))
    return acc


def _sym_x_at(dag: Dag, idx_bits, log_m: int, shift: int) -> Wire:
    """x = shift * w^rev(idx) over the current domain (bit k of idx maps to
    exponent 2^(log_m-1-k) under bit reversal)."""
    pairs = [(b, log_m - 1 - k) for k, b in enumerate(idx_bits)]
    return dag.mul_const(_pow_w_of_bits(dag, pairs, log_m), shift)


def _sym_fold_coset(dag: Dag, alg: RecExtAlgebra, evals, beta, chunk_bits,
                    arity_bits: int, shift: int, log_m: int, label: str):
    """Mirror of fri.verifier._fold_coset: radix-2 cascades over wire pairs.
    Within cascade t, x = cur_shift * w^rev(gidx, cur_log) where gidx =
    chunk * 2^(arity_bits-t) + 2j — the j-part of the exponent is constant,
    the chunk-part is one select-product shared across j."""
    vals = list(evals)
    b = beta
    cur_shift = shift
    for t in range(arity_bits):
        cur_log = log_m - t
        low = arity_bits - t          # constant low bits of gidx (from 2j)
        w = gl.primitive_root_of_unity(cur_log)
        # chunk-dependent factor, shared by every j in this cascade
        pairs = [(bit, cur_log - 1 - (low + i))
                 for i, bit in enumerate(chunk_bits)]
        chunk_factor = _pow_w_of_bits(dag, pairs, cur_log)
        new_vals = []
        for j in range(len(vals) // 2):
            e_const = 0
            for k in range(low):
                if (2 * j >> k) & 1:
                    e_const += 1 << (cur_log - 1 - k)
            xc = (cur_shift * pow(w, e_const, P)) % P
            x = dag.mul_const(chunk_factor, xc)
            inv_x = dag.inverse(x, f"{label}:x t{t} j{j}")
            v0, v1 = vals[2 * j], vals[2 * j + 1]
            s = alg.add(v0, v1)
            d_ = alg.sub(v0, v1)
            tt = alg.mul(b, alg.mul_base(d_, inv_x))
            new_vals.append(alg.mul_const(alg.add(s, tt), _INV2))
        vals = new_vals
        b = alg.mul(b, b)
        cur_shift = (cur_shift * cur_shift) % P
    assert len(vals) == 1
    return vals[0]


def _sym_verify_fri(dag: Dag, alg: RecExtAlgebra, wfri: WFriProof,
                    combine, oracle_caps, degree_bits: int,
                    ch: SymChallenger, config: FriConfig, tlabel: str):
    arities = config.reduction_arity_bits(degree_bits)
    betas = []
    for cap in wfri.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge())
    for c in wfri.final_poly:
        ch.observe_extension(c)

    ch.observe_element(wfri.pow_witness)
    pow_response = ch.get_challenge()
    pbits = dag.bits(pow_response, 64, f"{tlabel}:pow")
    for k in range(64 - config.proof_of_work_bits, 64):
        dag.assert_zero(pbits[k], f"{tlabel}:pow bit {k}")

    log_m = degree_bits + config.rate_bits
    final_log = log_m - sum(arities)

    all_idx_bits = []
    for q in range(config.num_query_rounds):
        c = ch.get_challenge()
        all_idx_bits.append(dag.bits(c, 64, f"{tlabel}:q{q}")[:log_m])

    for q, (idx_bits, (evals_per_oracle, init_proofs, steps)) in enumerate(
            zip(all_idx_bits, wfri.query_rounds)):
        lbl = f"{tlabel}:q{q}"
        for o, (evals, sibs) in enumerate(zip(evals_per_oracle, init_proofs)):
            _sym_verify_merkle(dag, evals, idx_bits, sibs, oracle_caps[o],
                               f"{lbl}:oracle{o}")
        old_eval = combine(idx_bits, evals_per_oracle)

        bits = idx_bits
        shift = gl.GENERATOR
        cur_log = log_m
        for s, ((step_evals, step_sibs), arity_bits, beta, cap) in enumerate(
                zip(steps, arities, betas, wfri.commit_phase_merkle_caps)):
            within = bits[:arity_bits]
            sel = dag.mux(within, [[e[0], e[1]] for e in step_evals])
            dag.assert_eq(sel[0], old_eval[0], f"{lbl}:fold{s}:re")
            dag.assert_eq(sel[1], old_eval[1], f"{lbl}:fold{s}:im")
            chunk_bits = bits[arity_bits:]
            # leaf layout [c0 x arity | c1 x arity] (fri/proof.py)
            leaf = [e[0] for e in step_evals] + [e[1] for e in step_evals]
            _sym_verify_merkle(dag, leaf, chunk_bits, step_sibs, cap,
                               f"{lbl}:fold{s}")
            old_eval = _sym_fold_coset(dag, alg, step_evals, beta, chunk_bits,
                                       arity_bits, shift, cur_log,
                                       f"{lbl}:fold{s}")
            for _ in range(arity_bits):
                shift = (shift * shift) % P
            cur_log -= arity_bits
            bits = chunk_bits

        assert cur_log == final_log
        x_final = _sym_x_at(dag, bits, cur_log, shift) if cur_log \
            else dag.constant(shift)
        acc = alg.zero
        for coeff in reversed(wfri.final_poly):
            acc = alg.add(alg.mul_base(acc, x_final), coeff)
        alg.assert_eq(acc, old_eval, f"{lbl}:final poly")


# --------------------------------------------------------------------------
# Symbolic per-table STARK verification (mirrors verifier.py)
# --------------------------------------------------------------------------

def _fri_batch_values(op: WOpenings, zero: Wire):
    """Opened values per FRI batch — StarkOpeningSet.fri_batches over wires."""
    zeta = op.local_values + op.auxiliary_polys + op.quotient_polys
    zeta_next = op.next_values + op.auxiliary_polys_next
    ctl_first = [(z, zero) for z in op.ctl_zs_first]
    return [zeta, zeta_next, ctl_first]


def _sym_verify_table(dag: Dag, alg: RecExtAlgebra, stark, wproof: WStarkProof,
                      config: StarkConfig, ch: SymChallenger, ctl_vars,
                      num_lookup_columns: int, lookup_challenges,
                      tlabel: str, publics=()):
    op = wproof.openings
    degree_bits = wproof.degree_bits
    n = 1 << degree_bits

    ch.observe_cap(wproof.auxiliary_polys_cap)
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(wproof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    zn = alg.pow_const(zeta, n)
    # zeta^n != 1  <=>  (zeta^n - 1) invertible (witnessed)
    z_h = alg.sub(zn, alg.one)
    z_h_inv = alg.inverse(z_h, f"{tlabel}:zeta in subgroup")  # noqa: F841

    batch_values = _fri_batch_values(op, dag.zero)
    for batch_vals in batch_values:
        for c in batch_vals:
            ch.observe_extension(c)

    g = gl.primitive_root_of_unity(degree_bits)
    g_last = gl.host_pow(g, n - 1)
    z_last = alg.sub(zeta, alg.constant(g_last))
    l_first = alg.mul(z_h, alg.inverse(
        alg.mul_const(alg.sub(zeta, alg.one), n), f"{tlabel}:l_first"))
    l_last = alg.mul(alg.mul_const(z_h, g_last), alg.inverse(
        alg.mul_const(alg.sub(zeta, alg.constant(g_last)), n),
        f"{tlabel}:l_last"))

    consumer = ConstraintConsumer(
        alg, [alg.from_base(al) for al in alphas], z_last, l_first, l_last)

    lookup_vars = None
    if stark.uses_lookups():
        lookup_vars = (op.auxiliary_polys[:num_lookup_columns],
                       op.auxiliary_polys_next[:num_lookup_columns],
                       lookup_challenges)

    local = ExtRows(op.local_values)
    nxt = ExtRows(op.next_values)
    eval_vanishing_poly(alg, stark, local, nxt, lookup_vars, ctl_vars,
                        consumer, publics)

    factor = stark.quotient_degree_factor
    for i, acc in enumerate(consumer.accs):
        chunk = op.quotient_polys[i * factor:(i + 1) * factor]
        red = alg.zero
        for qv in reversed(chunk):
            red = alg.add(alg.mul(red, zn), qv)
        alg.assert_eq(alg.mul(z_h, red), acc,
                      f"{tlabel}:quotient identity ch{i}")

    # FRI
    alpha = ch.get_extension_challenge()
    log_m = degree_bits + config.fri_config.rate_bits
    max_polys = max(len(b) for b in batch_values)
    alpha_pows = [alg.one]
    for _ in range(max_polys - 1):
        alpha_pows.append(alg.mul(alpha_pows[-1], alpha))

    gg = (g, 0)
    points = [zeta, alg.mul(zeta, alg.constant(gg[0])), alg.one]
    batch_consts = []
    for point, opens in zip(points, batch_values):
        cz = alg.zero
        for i, ov in enumerate(opens):
            cz = alg.add(cz, alg.mul(alpha_pows[i], ov))
        shift = alg.pow_const(alpha, len(opens)) if len(opens) else alg.one
        batch_consts.append((point, cz, shift))

    num_columns = stark.num_columns
    num_aux = len(op.auxiliary_polys)
    num_quot = len(op.quotient_polys)
    ranges = [(num_columns, num_aux, num_quot),
              (num_columns, num_aux, 0),
              (0, 0, 0)]  # batch 2 handled specially (ctl_zs range)
    total_ctl_zs = len(op.ctl_zs_first)

    def combine(idx_bits, evals_per_oracle):
        x = _sym_x_at(dag, idx_bits, log_m, gl.GENERATOR)
        acc = alg.zero
        for bi, (point, cz, shift) in enumerate(batch_consts):
            red = alg.zero
            i = 0
            if bi < 2:
                nc, na, nq = ranges[bi]
                sources = [(0, 0, nc), (1, 0, na), (2, 0, nq)]
            else:
                sources = [(1, num_aux - total_ctl_zs, num_aux)]
            for o, start, stop in sources:
                for cidx in range(start, stop):
                    v = evals_per_oracle[o][cidx]
                    red = alg.add(red, alg.mul_base(alpha_pows[i], v))
                    i += 1
            num = alg.sub(red, cz)
            den = (dag.sub(x, point[0]), dag.sub(dag.zero, point[1]))
            quot = alg.mul(num, alg.inverse(den, f"{tlabel}:combine b{bi}"))
            acc = alg.add(alg.mul(acc, shift), quot)
        return acc

    oracle_caps = [wproof.trace_cap, wproof.auxiliary_polys_cap,
                   wproof.quotient_polys_cap]
    _sym_verify_fri(dag, alg, wproof.opening_proof, combine, oracle_caps,
                    degree_bits, ch, config.fri_config, tlabel)


# --------------------------------------------------------------------------
# Whole-AllProof DAG
# --------------------------------------------------------------------------

@dataclass
class VerifierDag:
    dag: Dag
    wproof: WAllProof                 # wire mirror (public-input layout);
    #                                   the LAST child for chain recordings
    num_public_inputs: int
    claim_wires: List = None          # 48 wires: rb(8) + ra(8) + userdata(32)


def record_verifier(starks: Sequence, ctls, config: StarkConfig,
                    template: AllProof, cap_pins=None) -> VerifierDag:
    """Record the full verify_proof dataflow for proofs shaped like
    `template`.  dag.evaluate(flatten_proof(p)) == native verify_proof(p).

    cap_pins: optional {table_index: (2^cap, 4) int rows} pinning that
    table's trace cap to constants — the verifying-key check when the
    recorded proof is a shrink proof (its program-table cap identifies the
    circuit)."""
    dag = Dag()
    alg = RecExtAlgebra(dag)
    wp = reflect_proof(dag, template)
    _record_one(dag, alg, starks, ctls, config, wp, cap_pins)
    claim = wp.roots_before + wp.roots_after + wp.userdata
    return VerifierDag(dag=dag, wproof=wp, num_public_inputs=len(dag.pub),
                       claim_wires=claim)


def record_chain(starks: Sequence, ctls, config: StarkConfig,
                 templates: Sequence[AllProof],
                 cap_pins_list: Sequence) -> VerifierDag:
    """Record a DAG verifying a CHAIN of proofs of one table system
    (stage R3, the aggregation node — reference analog
    fixed_recursive_verifier.rs:613-695): each child proof is fully
    verified (with its own Fiat-Shamir transcript and its verifying key
    pinned via cap_pins_list[i]), consecutive claims are linked by the
    continuation constraints `lhs.roots_after == rhs.roots_before` and
    equal userdata, and the recorded claim is the COMBINED claim
    (first.roots_before, last.roots_after, userdata).

    Public-input layout = flatten_proof(child 0) ++ flatten_proof(child 1)
    ++ ... in order."""
    dag = Dag()
    alg = RecExtAlgebra(dag)
    wps = [reflect_proof(dag, t) for t in templates]
    for wp, pins in zip(wps, cap_pins_list):
        _record_one(dag, alg, starks, ctls, config, wp, pins)
    for c, (a, b) in enumerate(zip(wps, wps[1:])):
        for i in range(DIGEST * 2):
            dag.assert_eq(a.roots_after[i], b.roots_before[i],
                          f"chain {c}: roots_after != roots_before [{i}]")
        for i in range(32):
            dag.assert_eq(a.userdata[i], b.userdata[i],
                          f"chain {c}: userdata mismatch [{i}]")
    claim = wps[0].roots_before + wps[-1].roots_after + wps[0].userdata
    return VerifierDag(dag=dag, wproof=wps[-1],
                       num_public_inputs=len(dag.pub), claim_wires=claim)


def _record_one(dag: Dag, alg: RecExtAlgebra, starks: Sequence, ctls,
                config: StarkConfig, wp: WAllProof, cap_pins=None):
    """Append the verification of one reflected AllProof to `dag`."""
    num_tables = len(starks)

    for t, rows in (cap_pins or {}).items():
        for r, row in enumerate(rows):
            for i, v in enumerate(row):
                dag.assert_eq(wp.stark_proofs[t].trace_cap[r][i],
                              dag.constant(int(v)),
                              f"t{t}:vk cap[{r}][{i}]")

    ch = SymChallenger(dag)
    for t in wp.stark_proofs:
        ch.observe_cap(t.trace_cap)
    ch.observe_elements(wp.roots_before)
    ch.observe_elements(wp.roots_after)
    ch.observe_elements(wp.userdata)

    ctl_challenges = get_grand_product_challenge_set(ch,
                                                     config.num_challenges)

    num_lookup_columns = [s.num_lookup_helper_columns(config) for s in starks]
    num_helper_ctl = num_ctl_helper_columns_by_table(ctls, num_tables)
    openings_per_table = [(t.openings.auxiliary_polys,
                           t.openings.auxiliary_polys_next)
                          for t in wp.stark_proofs]
    ctl_vars_per_table = ctl_check_vars_from_proofs(
        openings_per_table, ctls, ctl_challenges, num_lookup_columns,
        num_helper_ctl)

    for t, (stark, wproof) in enumerate(zip(starks, wp.stark_proofs)):
        state = ch.compact()
        for i in range(len(state)):
            dag.assert_eq(state[i], wproof.init_challenger_state[i],
                          f"t{t}:challenger state {i}")
        lookup_challenges = [c.beta for c in ctl_challenges.challenges] \
            if stark.uses_lookups() else None
        publics = stark.public_inputs(wp.roots_before, wp.roots_after,
                                      wp.userdata) \
            if stark.num_public_inputs else ()
        _sym_verify_table(dag, alg, stark, wproof, config, ch,
                          ctl_vars_per_table[t], num_lookup_columns[t],
                          lookup_challenges, f"t{t}", publics)

    # cross-table lookup sum check (verify_cross_table_lookups over wires)
    iters = [iter(t.openings.ctl_zs_first) for t in wp.stark_proofs]
    for index, ctl in enumerate(ctls):
        seen = []
        for t in ctl.looking_tables:
            if t.table not in seen:
                seen.append(t.table)
        for c in range(config.num_challenges):
            looking = dag.zero
            for t in seen:
                looking = dag.add(looking, next(iters[t]))
            looked = next(iters[ctl.looked_table.table])
            dag.assert_eq(looking, looked, f"ctl {index} ch{c} sum")
    for it in iters:
        for _ in it:
            raise ValueError("unconsumed ctl_zs_first opening")
