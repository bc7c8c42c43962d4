"""zkm_tpu_torch STARK pieces against zkm_tpu: CTL and lookup aux columns
on the Logic table, the quotient values of LogicStark, the FRI fold and the
opening evaluations.  Equality is exact (tolerance zero)."""

import numpy as np
import torch

from zkm_tpu.field import extension as rgl2
from zkm_tpu.field import goldilocks as rgl
from zkm_tpu.fri import oracle as rfri_oracle
from zkm_tpu.fri import prover as rfri_prover
from zkm_tpu.stark import columns as rcolumns
from zkm_tpu.stark import cross_table_lookup as rctl
from zkm_tpu.stark import lookup as rlookup
from zkm_tpu.stark.algebra import ExtAlgebra, ExtRows
from zkm_tpu.stark.constraint_consumer import ConstraintConsumer
from zkm_tpu.stark.vanishing_poly import eval_vanishing_poly
from zkm_tpu.tables import logic as rlogic
from zkm_tpu_torch.convert import from_u64, to_u64
from zkm_tpu_torch.field import ntt
from zkm_tpu_torch.fri import oracle as fri_oracle
from zkm_tpu_torch.fri import prover as fri_prover
from zkm_tpu_torch.stark import columns
from zkm_tpu_torch.stark import cross_table_lookup as ctl
from zkm_tpu_torch.stark import lookup
from zkm_tpu_torch.stark import prover
from zkm_tpu_torch.tables import logic

P = rgl.P


def _logic_rows(seed: int, log_rows: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = (1 << log_rows) - 3          # a few padding rows at the end
    ops = np.stack([rng.integers(0, 4, k), rng.integers(0, 1 << 32, k),
                    rng.integers(0, 1 << 32, k)], axis=1)
    return logic.generate_rows(ops, min_rows=1 << log_rows)


def _self_ctl(lib_logic, lib_ctl):
    cols, filt = tuple(lib_logic.ctl_data()), lib_logic.ctl_filter()
    twc = lib_ctl.TableWithColumns
    return lib_ctl.CrossTableLookup((twc(0, cols, filt),), twc(0, cols, filt))


CHALLENGES = [(0x1234567890ABCDEF, 0x0FEDCBA987654321),
              (P - 5, 3)]


def test_ctl_helper_and_z_columns_match_reference():
    rows = _logic_rows(1, 6)
    ref = rctl.cross_table_lookup_data(
        [rgl.from_u64(rows)], [_self_ctl(rlogic, rctl)],
        rctl.GrandProductChallengeSet(
            [rctl.GrandProductChallenge(b, g) for b, g in CHALLENGES]), 3)
    mine = ctl.cross_table_lookup_data(
        [from_u64(rows)], [_self_ctl(logic, ctl)],
        ctl.GrandProductChallengeSet(
            [ctl.GrandProductChallenge(b, g) for b, g in CHALLENGES]), 3)
    assert len(mine[0].zs_columns) == len(ref[0].zs_columns) == 4
    assert mine[0].num_ctl_helper_polys() == ref[0].num_ctl_helper_polys()
    for a, b in zip(mine[0].zs_columns, ref[0].zs_columns):
        for h, rh in zip(a.helper_columns, b.helper_columns):
            assert np.array_equal(to_u64(h), rgl.to_u64(rh))
        assert np.array_equal(to_u64(a.z), rgl.to_u64(b.z))


def test_lookup_helper_columns_match_reference():
    """Three looked-up column-sets, one filtered: two helper columns (the
    chunked masked inverses) plus the forward Z."""
    rows = _logic_rows(2, 6)

    def make(lib_lookup, lib_columns):
        col = lib_columns.Column
        return lib_lookup.Lookup(
            columns=(col.single(4), col.single(5), col.single(40)),
            table_column=col.single(logic.RESULT),
            frequencies_column=col.single(logic.IS_AND),
            filter_columns=(None, lib_columns.Filter.new_simple(
                col.single(logic.IS_OR)), None))

    for challenge in (12345, P - 1):
        ref = rlookup.lookup_helper_columns(
            make(rlookup, rcolumns), rgl.from_u64(rows), challenge, 3)
        mine = lookup.lookup_helper_columns(
            make(lookup, columns), from_u64(rows), challenge, 3)
        assert len(mine) == len(ref) == 3
        for a, b in zip(mine, ref):
            assert np.array_equal(to_u64(a), rgl.to_u64(b))


def test_logic_quotient_values_match_reference():
    """LogicStark with its self-CTL at 2^6 rows, trace plus four aux columns
    (random: the quotient is a fixed function of them either way).  The
    reference is zkm_tpu's generic constraint code (`eval_vanishing_poly`
    on its host algebra, the verifier's path), evaluated point by point
    over the 2n coset; its jitted scheduled path costs ~20 s of compile."""
    degree_bits = 6
    n, m = 1 << degree_bits, 2 << degree_bits
    rows = _logic_rows(3, degree_bits)
    rng = np.random.default_rng(3)
    aux = rng.integers(0, P, size=(4, n), dtype=np.uint64)
    alphas = [int(a) for a in rng.integers(0, P, size=2, dtype=np.uint64)]

    def structure(lib_logic):
        cols, filt = tuple(lib_logic.ctl_data()), lib_logic.ctl_filter()
        return tuple((0, ci, (cols,), (filt,)) for ci in (0, 0, 1, 1))

    trace_coeffs, aux_coeffs = ntt.intt(from_u64(rows)), ntt.intt(from_u64(aux))
    mine = prover.quotient_values(
        logic.LogicStark(), degree_bits, trace_coeffs, aux_coeffs, alphas, 0,
        structure(logic), CHALLENGES)
    got = np.stack([to_u64(q) for q in mine])

    full = to_u64(torch.cat([ntt.lde(trace_coeffs, 1),
                             ntt.lde(aux_coeffs, 1)]))
    w = rgl.primitive_root_of_unity(degree_bits + 1)
    g_last = rgl.host_pow(rgl.primitive_root_of_unity(degree_bits), n - 1)
    alg = ExtAlgebra()
    for i in range(m):
        x = rgl.GENERATOR * pow(w, i, P) % P
        z_h = (pow(x, n, P) - 1) % P
        col = [(int(v), 0) for v in full[:, i]]
        col_next = [(int(v), 0) for v in full[:, (i + 2) % m]]
        ctl_vars = rctl.build_ctl_check_vars(
            col[rlogic.NUM_COLUMNS:], col_next[rlogic.NUM_COLUMNS:], 0,
            structure(rlogic), CHALLENGES)
        consumer = ConstraintConsumer(
            alg, [(a, 0) for a in alphas], ((x - g_last) % P, 0),
            (z_h * rgl.host_inv(n * (x - 1)) % P, 0),
            (z_h * g_last * rgl.host_inv(n * (x - g_last)) % P, 0))
        eval_vanishing_poly(alg, rlogic.LogicStark(), ExtRows(col),
                            ExtRows(col_next), None, ctl_vars, consumer)
        want = [alg.mul(acc, (rgl.host_inv(z_h), 0)) for acc in consumer.accs]
        assert [(int(q), 0) for q in got[:, i]] == want, i


def test_fold_layer_matches_reference():
    rng = np.random.default_rng(5)
    log_m, arity_bits, shift = 8, 4, 7
    v = rng.integers(0, P, size=(2, 1 << log_m), dtype=np.uint64)
    beta = (int(rng.integers(0, P, dtype=np.uint64)), 99)
    ref, ref_log, ref_shift = rfri_prover.fold_layer(
        rgl2.from_u64_pair(v[0], v[1]), beta, arity_bits, log_m, shift)
    mine, my_log, my_shift = fri_prover.fold_layer(
        (from_u64(v[0]), from_u64(v[1])), beta, arity_bits, log_m, shift)
    assert (my_log, my_shift) == (ref_log, ref_shift)
    assert np.array_equal(to_u64(mine[0]), rgl.to_u64(ref[0]))
    assert np.array_equal(to_u64(mine[1]), rgl.to_u64(ref[1]))
    leaves = fri_prover._chunk_leaves(mine, 4)
    ref_leaves = rfri_prover._chunk_leaves(ref, 4)
    assert np.array_equal(to_u64(leaves), rgl.to_u64(ref_leaves))


def test_eval_columns_at_many_matches_reference():
    rng = np.random.default_rng(6)
    coeffs = rng.integers(0, P, size=(5, 1 << 5), dtype=np.uint64)
    z = (int(rng.integers(0, P, dtype=np.uint64)),
         int(rng.integers(0, P, dtype=np.uint64)))
    zn = rgl2.host_mul(z, (rgl.primitive_root_of_unity(5), 0))
    ref = rfri_oracle.eval_columns_at_many(
        [(rgl.from_u64(coeffs), z), (rgl.from_u64(coeffs), zn)],
        extra=[rgl.sum_axis(rgl.from_u64(coeffs), -1)])
    mine = fri_oracle.eval_columns_at_many(
        [(from_u64(coeffs), z), (from_u64(coeffs), zn)],
        extra=[ntt.gl.sum_axis(from_u64(coeffs), -1)])
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        assert np.array_equal(a, b)


def test_lde_points_match_reference():
    for log_m in (3, 8):
        ref = rfri_oracle.lde_points_bitrev(log_m, 7)
        want = ref[0].astype(np.uint64) | (ref[1].astype(np.uint64) << 32)
        got = to_u64(fri_oracle.lde_points_bitrev(log_m, 7, from_u64(
            np.zeros(1, dtype=np.uint64)).device))
        assert np.array_equal(got, want)
