"""zkm_tpu_torch's six SPONGE_SUBSET tables and their CTLs against zkm_tpu:
the frozen toy-segment witness, the trace builders, the quotient values,
the CTL topology, single-table proofs and (slow) the whole segment proof.
Equality is exact (tolerance zero).

The two data files are made again with

    python tests/test_torch_segment.py --write

which runs the reference's witness generation on `bench._toy_segment()`
and its whole SPONGE_SUBSET proof under standard_fast_config (many
minutes on a CPU).
"""

import copy
import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

import bench  # noqa: E402
from zkm_tpu.field import goldilocks as rgl  # noqa: E402
from zkm_tpu.recursion import flatten_proof as ref_flatten_proof  # noqa: E402
from zkm_tpu.stark import all_stark as rall  # noqa: E402
from zkm_tpu.stark import cross_table_lookup as rctl  # noqa: E402
from zkm_tpu.stark.algebra import ExtAlgebra, ExtRows  # noqa: E402
from zkm_tpu.stark.config import StarkConfig as RefStarkConfig  # noqa: E402
from zkm_tpu.stark.constraint_consumer import ConstraintConsumer  # noqa: E402
from zkm_tpu.stark.vanishing_poly import eval_vanishing_poly  # noqa: E402
from zkm_tpu.stark.verifier import verify_proof as ref_verify_proof  # noqa: E402
from zkm_tpu.tables import arithmetic as rarith  # noqa: E402
from zkm_tpu.tables import memory as rmem  # noqa: E402
from zkm_tpu.tables import poseidon as rposeidon  # noqa: E402
from zkm_tpu.tables import poseidon_sponge as rpsponge  # noqa: E402
from zkm_tpu.witness import generation as rgen  # noqa: E402
from zkm_tpu_torch import host  # noqa: E402
from zkm_tpu_torch.convert import (from_u64, proof_to_plain,  # noqa: E402
                                   to_u64, traces_from_rows)
from zkm_tpu_torch.field import ntt  # noqa: E402
from zkm_tpu_torch.stark import cross_table_lookup as ctl  # noqa: E402
from zkm_tpu_torch.stark import prover  # noqa: E402
from zkm_tpu_torch.stark.all_stark import (SPONGE_SUBSET, Table,  # noqa: E402
                                           make_all_stark)
from zkm_tpu_torch.stark.config import StarkConfig  # noqa: E402
from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues,  # noqa: E402
                                       flat_sha256, flatten_proof)
from zkm_tpu_torch.stark.verifier import verify_proof  # noqa: E402
from zkm_tpu_torch.tables import arithmetic, memory, poseidon  # noqa: E402
from zkm_tpu_torch.tables import poseidon_sponge as psponge  # noqa: E402
from zkm_tpu_torch.tables.cpu import columns as cc  # noqa: E402
from zkm_tpu_torch.witness import trace_set  # noqa: E402

from test_torch_proof import to_reference  # noqa: E402

P = rgl.P
WITNESS, REFERENCE = trace_set.TOY_WITNESS, trace_set.TOY_REFERENCE
CHALLENGES = [(0x1234567890ABCDEF, 0x0FEDCBA987654321), (P - 5, 3)]


def reference_trace_set(min_rows: int = 64):
    return rgen.generate_segment_traces(bench._toy_segment(), sponge=True,
                                        min_rows=min_rows)


# ---------------------------------------------------------------------------
# 1. The frozen witness.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh():
    return reference_trace_set()


@pytest.fixture(scope="module")
def toy():
    return trace_set.load_toy_segment()


@pytest.fixture(scope="module")
def frozen(toy):
    return toy[0]


def _plain_ops(ts):
    """The TraceSet's ops of either package as plain tuples."""
    return {
        "memory": [(bool(o.filter), o.timestamp, bool(o.is_read), o.context,
                    o.segment, o.virt, o.value) for o in ts.memory_ops],
        "arith": [(o.flag, o.in0, o.in1, o.result) for o in ts.arith_ops],
        "logic": [tuple(int(v) for v in o) for o in ts.logic_ops],
        "poseidon": [([int(v) for v in i], int(t))
                     for i, t in ts.poseidon_inputs],
        "sponge": [([tuple(a) for a in o.base_address], o.timestamp, o.input)
                   for o in ts.poseidon_sponge_ops],
    }


def test_frozen_witness_matches_fresh_generation(fresh, frozen):
    assert np.array_equal(frozen.cpu_rows, fresh.cpu_rows)
    assert _plain_ops(frozen) == _plain_ops(fresh)
    assert frozen.cpu_rows[-1, cc.IS_EXIT_KERNEL] == 1


# ---------------------------------------------------------------------------
# 2. Trace builders.
# ---------------------------------------------------------------------------

def _random_memory_ops(rng, k=150):
    """Consistent memory ops: a read returns the last value written at its
    address (0 before any write); dummy (filter 0) ops are reads; some
    addresses lie far apart so that `_fill_gaps` inserts reads."""
    addrs = [(int(rng.integers(0, 2)), int(rng.integers(0, 5)),
              int(rng.choice([0, 4, 8, int(rng.integers(0, 1 << 12))])))
             for _ in range(24)]
    addrs.append((0, memory.SEG_REGISTER_FILE, 0))        # R0
    values, ops, t = {}, [], 0
    for _ in range(k):
        ctx, seg, virt = addrs[int(rng.integers(0, len(addrs)))]
        t += int(rng.integers(1, 40))
        filt = bool(rng.integers(0, 8))
        is_read = not filt or bool(rng.integers(0, 2))
        if is_read:
            value = values.get((ctx, seg, virt), 0)
        else:
            value = int(rng.integers(0, 1 << 32))
            values[(ctx, seg, virt)] = 0 if (ctx, seg, virt) == addrs[-1] \
                else value
        ops.append((filt, t, is_read, ctx, seg, virt, value))
    return ops


def _random_arith_ops(rng, k=60):
    edge = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 31, 32]
    ops = []
    for i in range(k):
        flag = i % 26
        a = int(rng.choice(edge)) if rng.integers(0, 3) == 0 else \
            int(rng.integers(0, 1 << 32))
        b = int(rng.choice(edge)) if rng.integers(0, 3) == 0 else \
            int(rng.integers(0, 1 << 32))
        ops.append((flag, a, b))
    return ops


def _random_perms(rng, k=40):
    return [([int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)],
             int(rng.integers(0, 1 << 30))) for _ in range(k)]


def _random_sponge_ops(rng, k=12):
    ops = []
    for _ in range(k):
        n = int(rng.choice([0, 4, 28, 31, 32, 36, 64, 100]))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        base = int(rng.integers(0, 1 << 20)) * 4
        addrs = [(0, 1, base + 4 * w) for w in range((n + 3) // 4)]
        ops.append((addrs, int(rng.integers(0, 1 << 20)), data))
    return ops


def _builder_cases(table, frozen_ts, rng):
    """(port rows, reference rows) on the frozen ops and on random ops."""
    if table == "Memory":
        for ops in ([tuple(o) for o in _plain_ops(frozen_ts)["memory"]],
                    _random_memory_ops(rng)):
            yield (memory.generate_rows([memory.MemoryOp(*o) for o in ops]),
                   rmem.generate_rows([rmem.MemoryOp(*o) for o in ops]))
    elif table == "Arithmetic":
        frozen_ops = [(o.flag, o.in0, o.in1) for o in frozen_ts.arith_ops]
        for ops in (frozen_ops, _random_arith_ops(rng)):
            yield (arithmetic.generate_rows([arithmetic.Op(*o) for o in ops]),
                   rarith.generate_rows([rarith.Op(*o) for o in ops]))
    elif table == "Poseidon":
        for ops in (frozen_ts.poseidon_inputs, _random_perms(rng)):
            yield (poseidon.generate_rows(ops, min_rows=64),
                   rgl.to_u64(rposeidon.generate_trace(ops, min_rows=64)))
    elif table == "PoseidonSponge":
        frozen_ops = _plain_ops(frozen_ts)["sponge"]
        for ops in (frozen_ops, _random_sponge_ops(rng)):
            yield (psponge.generate_rows(
                       [psponge.PoseidonSpongeOp(*o) for o in ops],
                       device="cpu"),
                   rpsponge.generate_rows(
                       [rgen.PoseidonSpongeOp(*o) for o in ops]))
    else:
        assert table == "Cpu"
        yield (trace_set.pad_cpu_rows(frozen_ts.cpu_rows, 64),
               frozen_ts.cpu_rows)
        yield (trace_set.pad_cpu_rows(frozen_ts.cpu_rows, 1 << 13),
               reference_trace_set(min_rows=1 << 13).cpu_rows)


@pytest.mark.parametrize("table", ["Memory", "Arithmetic", "Poseidon",
                                   "PoseidonSponge", "Cpu"])
def test_trace_builder_matches_reference(table, frozen):
    rng = np.random.default_rng(sum(map(ord, table)))
    cases = 0
    for mine, ref in _builder_cases(table, frozen, rng):
        ref = np.asarray(ref, dtype=np.uint64)
        assert mine.dtype == np.uint64 and mine.shape == ref.shape
        assert np.array_equal(mine, ref)
        cases += 1
    assert cases == 2


# ---------------------------------------------------------------------------
# 3. Quotient values.
# ---------------------------------------------------------------------------

def _ctl_structure(all_stark, table, num_challenges=2):
    """The static CTL aux layout `prove_single_table` builds for `table`
    of `all_stark` (looking groups with their helpers, then the looked
    side, per CTL and challenge)."""
    local = all_stark.tables.index(table)
    out = []
    for c in all_stark.ctls:
        for ci in range(num_challenges):
            group = [t for t in c.looking_tables if t.table == local]
            if group:
                nh = (len(group) + 1) // 2 if len(group) > 1 else 0
                out.append((nh, ci, tuple(t.columns for t in group),
                            tuple(t.filter for t in group)))
            if c.looked_table.table == local:
                out.append((0, ci, (c.looked_table.columns,),
                            (c.looked_table.filter,)))
    return tuple(out)


def _num_lookup(stark, num_challenges=2):
    return sum(lk.num_helper_columns(3) for lk in stark.lookups()) \
        * num_challenges


# (table, points of the 2n coset checked: None = all)
QUOTIENT_CASES = [("Arithmetic", None), ("Memory", None), ("Poseidon", None),
                  ("PoseidonSponge", None), ("Cpu", None)]


@pytest.mark.parametrize("table,points", QUOTIENT_CASES)
def test_quotient_values_match_reference(table, points):
    """The stark's vanishing polynomial over the 2n coset at 2^6 rows, on a
    random trace and random aux columns (the quotient is a fixed function
    of them either way), with the real SPONGE_SUBSET CTL layout, lookups
    and (Cpu) 16 random publics, against zkm_tpu's generic constraint code
    on its host algebra point by point (the verifier's path)."""
    assert_quotient_matches_reference(table, points, SPONGE_SUBSET)


def assert_quotient_matches_reference(table, points, subset):
    """The check above for `table` with the CTL layout of `subset`."""
    tab = Table[table]
    mine_all = make_all_stark(subset)
    ref_all = rall.make_all_stark([rall.Table[t.name] for t in subset])
    stark = mine_all.starks[mine_all.tables.index(tab)]
    ref_stark = ref_all.starks[ref_all.tables.index(rall.Table[table])]
    assert type(stark).__name__ == type(ref_stark).__name__
    degree_bits = 6
    n, m = 1 << degree_bits, 2 << degree_bits
    rng = np.random.default_rng(40 + int(tab))
    structure = _ctl_structure(mine_all, tab)
    ref_structure = _ctl_structure(ref_all, rall.Table[table])
    num_lookup = _num_lookup(stark)
    num_aux = num_lookup + sum(s[0] for s in structure) + len(structure)
    rows = rng.integers(0, P, size=(stark.num_columns, n), dtype=np.uint64)
    aux = rng.integers(0, P, size=(num_aux, n), dtype=np.uint64)
    alphas = [int(a) for a in rng.integers(0, P, size=2, dtype=np.uint64)]
    publics = tuple(int(v) for v in rng.integers(
        0, P, size=stark.num_public_inputs, dtype=np.uint64))
    assert len(publics) == (16 if table == "Cpu" else 0)

    trace_coeffs = ntt.intt(from_u64(rows))
    aux_coeffs = ntt.intt(from_u64(aux))
    mine = prover.quotient_values(
        stark, degree_bits, trace_coeffs, aux_coeffs, alphas, num_lookup,
        structure, CHALLENGES, publics)
    got = np.stack([to_u64(q) for q in mine])

    full = to_u64(torch.cat([ntt.lde(trace_coeffs, 1),
                             ntt.lde(aux_coeffs, 1)]))
    w = rgl.primitive_root_of_unity(degree_bits + 1)
    g_last = rgl.host_pow(rgl.primitive_root_of_unity(degree_bits), n - 1)
    alg = ExtAlgebra()
    nc = stark.num_columns
    idx = range(m) if points is None else sorted(
        rng.choice(m, size=points, replace=False).tolist())
    for i in idx:
        x = rgl.GENERATOR * pow(w, i, P) % P
        z_h = (pow(x, n, P) - 1) % P
        col = [(int(v), 0) for v in full[:, i]]
        col_next = [(int(v), 0) for v in full[:, (i + 2) % m]]
        lookup_vars = None
        if num_lookup:
            lookup_vars = (col[nc:nc + num_lookup],
                           col_next[nc:nc + num_lookup],
                           [b for b, _ in CHALLENGES])
        ctl_vars = rctl.build_ctl_check_vars(
            col[nc:], col_next[nc:], num_lookup, ref_structure, CHALLENGES)
        consumer = ConstraintConsumer(
            alg, [(a, 0) for a in alphas], ((x - g_last) % P, 0),
            (z_h * rgl.host_inv(n * (x - 1)) % P, 0),
            (z_h * g_last * rgl.host_inv(n * (x - g_last)) % P, 0))
        eval_vanishing_poly(alg, ref_stark, ExtRows(col[:nc]),
                            ExtRows(col_next[:nc]), lookup_vars, ctl_vars,
                            consumer, publics)
        want = [alg.mul(acc, (rgl.host_inv(z_h), 0)) for acc in consumer.accs]
        assert [(int(q), 0) for q in got[:, i]] == want, i


# ---------------------------------------------------------------------------
# 4. CTL topology.
# ---------------------------------------------------------------------------

def _column_key(c):
    return (tuple(c.linear), tuple(c.next_linear), c.constant)


def _filter_key(f):
    if f is None:
        return None
    return (tuple((_column_key(a), _column_key(b)) for a, b in f.products),
            tuple(_column_key(c) for c in f.constants))


def _twc_key(t):
    return (t.table, tuple(_column_key(c) for c in t.columns),
            _filter_key(t.filter))


def _ctl_keys(ctls):
    return [(tuple(_twc_key(t) for t in c.looking_tables),
             _twc_key(c.looked_table)) for c in ctls]


@pytest.mark.parametrize("subset", ["sponge", "default", "memory_alone",
                                    "poseidon_alone"])
def test_ctl_topology_matches_reference(subset):
    tables = {"sponge": SPONGE_SUBSET,
              "default": (Table.Arithmetic, Table.Cpu, Table.Logic,
                          Table.Memory),
              "memory_alone": (Table.Memory,),
              "poseidon_alone": (Table.Poseidon,)}[subset]
    mine = make_all_stark(tables)
    ref = rall.make_all_stark([rall.Table[t.name] for t in tables])
    assert [t.name for t in mine.tables] == [t.name for t in ref.tables]
    assert [type(s).__name__ for s in mine.starks] == \
        [type(s).__name__ for s in ref.starks]
    assert _ctl_keys(mine.ctls) == _ctl_keys(ref.ctls)
    assert len(mine.ctls) == {"sponge": 6, "default": 3}.get(subset, 1)


def test_unported_table_is_named(monkeypatch):
    """All 12 tables are ported; a table missing from IMPLEMENTED would be
    named."""
    from zkm_tpu_torch.stark import all_stark
    assert set(all_stark.IMPLEMENTED) == set(Table)
    make_all_stark([Table.Cpu, Table.Keccak, Table.ShaCompress])
    for t in (Table.Keccak, Table.ShaCompress):
        monkeypatch.delitem(all_stark.IMPLEMENTED, t)
    with pytest.raises(NotImplementedError, match="Keccak, ShaCompress"):
        make_all_stark([Table.Cpu, Table.Keccak, Table.ShaCompress])


def _ctl_zs_first(rows, all_stark):
    """Each table's CTL Z values at row 0, as the verifier reads them."""
    challenges = ctl.GrandProductChallengeSet(
        [ctl.GrandProductChallenge(b, g) for b, g in CHALLENGES])
    data = ctl.cross_table_lookup_data(traces_from_rows(rows, "cpu"),
                                       all_stark.ctls, challenges, 3)
    return [[int(to_u64(z.z)[0]) for z in d.zs_columns] for d in data]


def test_ctl_zs_hold_on_frozen_witness_and_fail_when_tampered(toy):
    frozen, _, ref = toy
    all_stark = make_all_stark(SPONGE_SUBSET)
    rows = host.trace_set_traces(frozen, all_stark, device="cpu")
    heights = [r.shape[1].bit_length() - 1 for r in rows]
    assert heights == ref["natural_heights_log2"]
    zs = _ctl_zs_first(rows, all_stark)
    ctl.verify_cross_table_lookups(all_stark.ctls, zs, 2)
    rctl.verify_cross_table_lookups(
        rall.make_all_stark(rall.SPONGE_SUBSET).ctls, zs, 2)

    cpu = rows[all_stark.tables.index(Table.Cpu)]
    ch = cc.MEM_CHANNELS[0]
    used = np.nonzero(cpu[ch.used] == 1)[0]
    assert used.size
    cpu[ch.value, used[len(used) // 2]] ^= 1
    with pytest.raises(ValueError, match="cross-table lookup 5"):
        ctl.verify_cross_table_lookups(all_stark.ctls,
                                       _ctl_zs_first(rows, all_stark), 2)


# ---------------------------------------------------------------------------
# 5. Single-table proofs.
# ---------------------------------------------------------------------------

def _single_table_rows(table):
    rng = np.random.default_rng(7)
    if table == "Memory":
        ops = [memory.MemoryOp(*o) for o in _random_memory_ops(rng, 40)]
        return memory.generate_rows(ops)
    return poseidon.generate_rows(_random_perms(rng, 50), min_rows=64)


@pytest.mark.parametrize("table", ["Memory", "Poseidon"])
def test_single_table_proof_accepted_by_reference(table):
    tab = Table[table]
    all_stark = make_all_stark([tab])
    ref_all = rall.make_all_stark([rall.Table[table]])
    pv = PublicValues(MemRoots.from_image_id(bytes(range(32))),
                      MemRoots.from_image_id(bytes(range(32, 64))),
                      bytes(range(64, 96)))
    config = StarkConfig.standard_fast_config()
    proof = prover.prove_with_traces(
        all_stark.starks, config,
        traces_from_rows([_single_table_rows(table)], "cpu"),
        all_stark.ctls, pv, device="cpu")
    verify_proof(all_stark.starks, proof, all_stark.ctls, config)
    ref = to_reference(proof_to_plain(proof))
    ref_verify_proof(ref_all.starks, ref, ref_all.ctls,
                     RefStarkConfig.standard_fast_config())
    assert ref_flatten_proof(ref) == flatten_proof(proof)


# ---------------------------------------------------------------------------
# 6. The whole segment proof (minutes on the CPU; on the card it runs in
#    every `chip_smoke.py` run).
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_segment_proof_matches_reference_digest(toy):
    frozen, pv, ref = toy
    config = StarkConfig.standard_fast_config()
    proof = host.prove_trace_set(frozen, pv, config, device="cpu")
    assert [p.degree_bits for p in proof.stark_proofs] == \
        ref["natural_heights_log2"]
    assert flat_sha256(flatten_proof(proof)) == ref["sha256_flat"]
    host.verify_segment(proof, config)
    ref_all = rall.make_all_stark(rall.SPONGE_SUBSET)
    ref_verify_proof(ref_all.starks, to_reference(proof_to_plain(proof)),
                     ref_all.ctls, RefStarkConfig.standard_fast_config())
    bad = copy.deepcopy(proof)
    vals = bad.stark_proofs[1].proof.openings.local_values
    vals[0, 0] = (int(vals[0, 0]) + 1) % P
    with pytest.raises(ValueError):
        host.verify_segment(bad, config)


# ---------------------------------------------------------------------------
# The writer of the two data files.
# ---------------------------------------------------------------------------

def write_reference_files() -> None:
    from zkm_tpu.host import prove_segment, public_values_for_segment
    seg = bench._toy_segment()
    ts = rgen.generate_segment_traces(seg, sponge=True)
    trace_set.save_npz(WITNESS, ts)
    print(f"wrote {WITNESS} ({os.path.getsize(WITNESS)} bytes)", flush=True)
    pv = public_values_for_segment(seg)
    t0 = time.perf_counter()
    receipt = prove_segment(seg, RefStarkConfig.standard_fast_config())
    seconds = time.perf_counter() - t0
    flat = ref_flatten_proof(receipt.proof)
    ref = {
        "segment": "bench._toy_segment()",
        "config": "standard_fast_config",
        "subset": [t.name for t in rall.SPONGE_SUBSET],
        "public_values": {
            "roots_before": [int(v) for v in pv.roots_before.root],
            "roots_after": [int(v) for v in pv.roots_after.root],
            "userdata": bytes(pv.userdata).hex()},
        "natural_heights_log2": [int(p.degree_bits)
                                 for p in receipt.proof.stark_proofs],
        "num_flat_elements": len(flat),
        "sha256_flat": hashlib.sha256(b"".join(
            int(v).to_bytes(8, "little") for v in flat)).hexdigest(),
        "reference_prove_seconds": round(seconds, 1),
        "reference_prove_machine": f"{os.cpu_count()}-core CPU, "
                                   "zkm_tpu on JAX's CPU backend",
    }
    with open(REFERENCE, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(json.dumps(ref), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference_files()
