"""zkm_tpu_torch's six Keccak and SHA tables, their nine CTLs and the
row-level checkers against zkm_tpu: the trace builders on seeded ops, each
quotient point by point at 2^6 rows, the 15-CTL topology, the low-degree
check, and `check_ctls` / `check_stark_constraints` / the prover's
debug check on an honest and a tampered witness.  Equality is exact
(tolerance zero).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from zkm_tpu.stark import all_stark as rall  # noqa: E402
from zkm_tpu.stark import constraint_debug as rcdebug  # noqa: E402
from zkm_tpu.stark import ctl_debug as rctldebug  # noqa: E402
from zkm_tpu.tables import keccak as rkeccak  # noqa: E402
from zkm_tpu.tables import keccak_sponge as rksponge  # noqa: E402
from zkm_tpu.tables import sha_compress as rshac  # noqa: E402
from zkm_tpu.tables import sha_compress_sponge as rshacs  # noqa: E402
from zkm_tpu.tables import sha_extend as rshae  # noqa: E402
from zkm_tpu.tables import sha_extend_sponge as rshaes  # noqa: E402
from zkm_tpu.witness import generation as rgen  # noqa: E402
from zkm_tpu_torch import host  # noqa: E402
from zkm_tpu_torch.convert import (from_u64, to_u64,  # noqa: E402
                                   traces_from_rows)
from zkm_tpu_torch.stark import expr, prover  # noqa: E402
from zkm_tpu_torch.stark.all_stark import (FULL_SUBSET,  # noqa: E402
                                           KECCAK_SUBSET, Table,
                                           make_all_stark)
from zkm_tpu_torch.stark.config import StarkConfig  # noqa: E402
from zkm_tpu_torch.stark.constraint_debug import \
    check_stark_constraints  # noqa: E402
from zkm_tpu_torch.stark.cross_table_lookup import (  # noqa: E402
    CrossTableLookup, TableWithColumns)
from zkm_tpu_torch.stark.ctl_debug import check_ctls  # noqa: E402
from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues,  # noqa: E402
                                       flat_sha256, flatten_proof)
from zkm_tpu_torch.stark.stark import Stark  # noqa: E402
from zkm_tpu_torch.stark.stark_testing import \
    check_stark_low_degree  # noqa: E402
from zkm_tpu_torch.tables import keccak, keccak_sponge  # noqa: E402
from zkm_tpu_torch.tables import logic  # noqa: E402
from zkm_tpu_torch.tables import sha_compress, sha_compress_sponge  # noqa: E402
from zkm_tpu_torch.tables import sha_extend, sha_extend_sponge  # noqa: E402
from zkm_tpu_torch.witness import generation  # noqa: E402

from test_torch_full import split  # noqa: E402
from test_torch_segment import (_ctl_keys,  # noqa: E402
                                assert_quotient_matches_reference)

CPU = "cpu"
M32 = 0xFFFFFFFF
NEW_TABLES = ["Keccak", "KeccakSponge", "ShaExtend", "ShaExtendSponge",
              "ShaCompress", "ShaCompressSponge"]
_PORT_MODS = {"Keccak": keccak, "KeccakSponge": keccak_sponge,
              "ShaExtend": sha_extend, "ShaExtendSponge": sha_extend_sponge,
              "ShaCompress": sha_compress,
              "ShaCompressSponge": sha_compress_sponge}


# ---------------------------------------------------------------------------
# 1. Trace builders on seeded ops.
# ---------------------------------------------------------------------------

def _random_keccak_inputs(rng, k=3):
    """Lanes from every range, including above 2^63 (all-ones lanes too)."""
    out = []
    for _ in range(k):
        lanes = [int(v) for v in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
        lanes[int(rng.integers(0, 25))] = (1 << 64) - 1
        lanes[int(rng.integers(0, 25))] = 1
        out.append((lanes, int(rng.integers(0, 1 << 30))))
    return out


def _random_keccak_sponge_ops(rng):
    ops = []
    for n in (0, 4, 132, 136, 140, 272, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        base = int(rng.integers(0, 1 << 20)) * 4
        addrs = [(0, 1, base + 4 * w) for w in range(n // 4)]
        ops.append((addrs, int(rng.integers(0, 1 << 30)), data))
    return ops


def _random_sha_extend_ops(rng, k=20):
    ops = []
    for _ in range(k):
        inputs = [int(v) for v in rng.integers(0, 1 << 32, 4)]
        ops.append((0, 1, int(rng.integers(16, 1 << 20)) * 4,
                    int(rng.integers(0, 1 << 30)), inputs,
                    sha_extend.extend_step(*inputs)))
    return ops


def _random_sha_compress_ops(rng, k=3):
    ops = []
    for _ in range(k):
        hx = [int(v) for v in rng.integers(0, 1 << 32, 8)]
        hx[0] = M32
        w = [int(v) for v in rng.integers(0, 1 << 32, 64)]
        state = list(hx)
        for i in range(64):
            state = sha_compress.compress_round(state, w[i],
                                                sha_compress.SHA_COMPRESS_K[i])
        ops.append((0, 1, int(rng.integers(0, 1 << 20)) * 4,
                    int(rng.integers(0, 1 << 20)) * 4,
                    int(rng.integers(0, 1 << 30)), hx, w, state))
    return ops


def _builder_pair(table, rng):
    """(port rows, reference rows) on the same seeded ops."""
    if table == "Keccak":
        ops = _random_keccak_inputs(rng)
        return keccak.generate_rows(ops), rkeccak.generate_rows(ops)
    if table == "KeccakSponge":
        ops = _random_keccak_sponge_ops(rng)
        return (keccak_sponge.generate_rows(
                    [keccak_sponge.KeccakSpongeOp(*o) for o in ops]),
                rksponge.generate_rows([rgen.KeccakSpongeOp(*o)
                                        for o in ops]))
    if table.startswith("ShaExtend"):
        ops = _random_sha_extend_ops(rng)
        mine = [sha_extend.ShaExtendOp(*o) for o in ops]
        ref = [rgen.ShaExtendOp(*o) for o in ops]
        mod, rmod = ((sha_extend, rshae) if table == "ShaExtend"
                     else (sha_extend_sponge, rshaes))
        return mod.generate_rows(mine), rmod.generate_rows(ref)
    ops = _random_sha_compress_ops(rng)
    mine = [sha_compress.ShaCompressOp(*o) for o in ops]
    ref = [rgen.ShaCompressOp(*o) for o in ops]
    mod, rmod = ((sha_compress, rshac) if table == "ShaCompress"
                 else (sha_compress_sponge, rshacs))
    return mod.generate_rows(mine), rmod.generate_rows(ref)


@pytest.mark.parametrize("table", NEW_TABLES)
def test_trace_builder_matches_reference(table):
    mine, ref = _builder_pair(table, np.random.default_rng(
        sum(map(ord, table))))
    assert mine.dtype == np.uint64 and mine.shape == ref.shape
    assert mine.shape[0] == _PORT_MODS[table].NUM_COLUMNS
    assert np.array_equal(mine, ref)
    assert mine.any()


def test_keccak_rows_hold_lanes_above_2_63_exactly():
    lanes = [(1 << 64) - 1 - i for i in range(25)]
    rows = keccak.generate_rows([(lanes, 7)])
    lo, hi = rows[keccak.reg_a(0, 0)][0], rows[keccak.reg_a(0, 0) + 1][0]
    assert (int(lo), int(hi)) == (0xFFFFFFFF, 0xFFFFFFFF)
    check_stark_constraints(keccak.KeccakStark(), rows)


# ---------------------------------------------------------------------------
# 2. Quotient values point by point at 2^6 rows (FULL_SUBSET CTL layout).
# ---------------------------------------------------------------------------

# (table, points of the 2n coset checked: None = all): the host algebra
# walks Keccak's and KeccakSponge's constraint code per point, so those
# two check a seeded sample of points
HASH_QUOTIENT_CASES = [("Keccak", 6), ("KeccakSponge", 16),
                       ("ShaExtend", None), ("ShaExtendSponge", None),
                       ("ShaCompress", None), ("ShaCompressSponge", None)]


@pytest.mark.parametrize("table,points", HASH_QUOTIENT_CASES)
def test_quotient_values_match_reference(table, points):
    assert_quotient_matches_reference(table, points, FULL_SUBSET)


# ---------------------------------------------------------------------------
# 3. The 15-CTL topology.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subset", ["full", "keccak", "sha"])
def test_ctl_topology_matches_reference(subset):
    tables = {"full": FULL_SUBSET, "keccak": KECCAK_SUBSET,
              "sha": (Table.Arithmetic, Table.Cpu, Table.ShaExtend,
                      Table.ShaExtendSponge, Table.ShaCompress,
                      Table.ShaCompressSponge, Table.Logic,
                      Table.Memory)}[subset]
    mine = make_all_stark(tables)
    ref = rall.make_all_stark([rall.Table[t.name] for t in tables])
    assert [t.name for t in mine.tables] == [t.name for t in ref.tables]
    assert [type(s).__name__ for s in mine.starks] == \
        [type(s).__name__ for s in ref.starks]
    assert [s.num_columns for s in mine.starks] == \
        [s.num_columns for s in ref.starks]
    assert _ctl_keys(mine.ctls) == _ctl_keys(ref.ctls)
    assert len(mine.ctls) == {"full": 15, "keccak": 9, "sha": 9}[subset]


# ---------------------------------------------------------------------------
# 4. The low-degree check.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", NEW_TABLES)
def test_stark_low_degree(table):
    stark = make_all_stark(FULL_SUBSET).starks[int(Table[table])]
    assert type(stark).__name__ == table + "Stark"
    check_stark_low_degree(stark, device=CPU)


class _DegreeFiveStark(Stark):
    num_columns = 2

    def eval_generic(self, a, lv, nv, consumer):
        sq = a.mul(lv[0], lv[0])
        consumer.constraint(a.sub(a.mul(a.mul(sq, sq), lv[1]), lv[1]))


def test_low_degree_check_catches_a_degree_five_constraint():
    with pytest.raises(AssertionError, match="degree 3[0-9] > 29"):
        check_stark_low_degree(_DegreeFiveStark(), device=CPU)


def test_evaluate_ir_agrees_with_the_schedule():
    """The unscheduled evaluator and the level schedule give the same
    constraint values (ShaCompress, 2^5 random points)."""
    stark = sha_compress.ShaCompressStark()
    ir = expr.compile_stark(stark)
    rng = np.random.default_rng(5)
    gp = rng.integers(0, 1 << 64, (stark.num_columns, 32), dtype=np.uint64)
    local, nxt = from_u64(gp), from_u64(np.roll(gp, -1, axis=1))
    got = []
    expr.evaluate_ir(ir, lambda c: local[c], lambda c: nxt[c],
                     lambda kind, v: got.append(v))
    want = expr.evaluate_scheduled(expr.schedule_ir(ir), local, nxt)
    assert len(got) == want.shape[0]
    got = np.stack([to_u64(v) if isinstance(v, torch.Tensor)
                    else np.full(32, v, np.uint64) for v in got])
    assert np.array_equal(got, to_u64(want))


# ---------------------------------------------------------------------------
# 5. The checkers on the full guest's witness, honest and tampered.
# ---------------------------------------------------------------------------

# FULL_SUBSET without the page sponges' two tables, whose builders take a
# minute on the CPU: 10 tables and 12 CTLs, every new one among them
HASH_SUBSET = tuple(t for t in FULL_SUBSET
                    if t not in (Table.Poseidon, Table.PoseidonSponge))


@pytest.fixture(scope="module")
def full_rows():
    """The full guest's traces of HASH_SUBSET as raw u64 rows, built by
    the port (a witness without the page sponges)."""
    (_, segs, _), _ = split("full")
    ts = generation.generate_segment_traces(segs[0], keccak=True, sha=True,
                                            device=CPU)
    all_stark = make_all_stark(HASH_SUBSET)
    return all_stark, host.trace_set_traces(ts, all_stark, device=CPU)


def _ref_all_stark(all_stark):
    return rall.make_all_stark([rall.Table[t.name] for t in all_stark.tables])


def test_check_ctls_agrees_with_reference(full_rows):
    all_stark, rows = full_rows
    ref_ctls = _ref_all_stark(all_stark).ctls
    assert len(ref_ctls) == 12
    check_ctls(rows, all_stark.ctls)
    rctldebug.check_ctls(rows, ref_ctls)

    bad = [r.copy() for r in rows]
    ks = bad[all_stark.tables.index(Table.KeccakSponge)]
    ks[keccak_sponge.XORED_RATE.start + 3, 0] ^= 1
    msgs = []
    for fn, ctls in ((check_ctls, all_stark.ctls),
                     (rctldebug.check_ctls, ref_ctls)):
        # CTL 2: KeccakSponge -> Keccak inputs
        with pytest.raises(AssertionError, match="CTL 2 multiset") as e:
            fn(bad, ctls)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("table", NEW_TABLES)
def test_check_stark_constraints_agrees_with_reference(full_rows, table):
    """Honest rows pass; a tampered row is named, by both packages."""
    all_stark, rows = full_rows
    tab = Table[table]
    i = all_stark.tables.index(tab)
    stark, ref_stark = all_stark.starks[i], _ref_all_stark(all_stark).starks[i]
    assert type(stark).__name__ == type(ref_stark).__name__
    trace = rows[i]
    assert check_stark_constraints(stark, trace) == []
    assert rcdebug.check_stark_constraints(ref_stark, trace) == []

    bad = trace.copy()
    col, row = {"Keccak": (keccak.reg_c(2, 7), 5),
                "KeccakSponge": (keccak_sponge.LEN, 0),
                "ShaExtend": (sha_extend.W16, 5),
                "ShaExtendSponge": (sha_extend_sponge.IS_REAL, 1),
                "ShaCompress": (sha_compress.S0_VAL, 5),
                "ShaCompressSponge": (sha_compress_sponge.OUT.start, 1)}[table]
    bad[col, row] += 2
    got = check_stark_constraints(stark, bad, raise_on_error=False)
    want = rcdebug.check_stark_constraints(ref_stark, bad,
                                           raise_on_error=False)
    assert [v[:2] for v in got] == [v[:2] for v in want]
    assert got and all(row in rows_ or row - 1 in rows_
                       for _, rows_, _ in got)
    with pytest.raises(AssertionError, match=f"rows \\[.*{row}"):
        check_stark_constraints(stark, bad)


def test_prover_debug_keeps_the_digest_and_names_the_failing_row():
    """prove_with_traces(debug=True) on the frozen golden Logic statement
    gives the frozen digest (the check draws nothing from the transcript);
    with one result changed it stops, naming the row."""
    with open(os.path.join(HERE, "data", "golden_vectors.json")) as f:
        v = json.load(f)["logic_proof"]
    rows = logic.generate_rows([tuple(o) for o in v["ops"]], min_rows=16)
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    ctls = [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]
    pv = PublicValues(MemRoots.from_image_id(bytes([3] * 32)),
                      MemRoots.from_image_id(bytes([4] * 32)), bytes(32))

    def prove(rows):
        return prover.prove_with_traces(
            [logic.LogicStark()], StarkConfig.test_config(),
            traces_from_rows([rows], CPU), ctls, pv, device=CPU, debug=True)

    assert flat_sha256(flatten_proof(prove(rows))) == v["sha256_flat"]
    rows[logic.RESULT, 9] ^= 4
    with pytest.raises(AssertionError, match=r"LogicStark.*rows \[9\]"):
        prove(rows)
