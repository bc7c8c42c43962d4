"""zkm_tpu_torch's recursion (verifier DAG, shrink, binary aggregation,
circuit cache) and proof export against zkm_tpu, at tolerance zero.

Running zkm_tpu's recursion live is too slow for the suite, so the port is
held against two frozen records written from zkm_tpu:

  zkm_tpu_torch/data/recursion_toy_reference.json
      two Logic proofs (roots 0->1->2) under `_rconfig`, as zkm_tpu.export
      JSON; the shrink circuit's DAG (counts, a digest of its op list, of
      its assertions and of its wire values on proof 0), the five shrink
      traces' digests, the program caps, both shrink proofs' and the
      aggregation root's flattened sha256;
  zkm_tpu_torch/data/recursion_fib_reference.json
      fib(40) split at seg_size 1800 and proved under the Cpu/Logic/Memory
      subset and test_config (scripts/recursion_stages.py's workload):
      the segments, both inner proofs' flattened sha256, the shrink DAG's
      counts and op digest, the program cap, the shrink traces' heights
      and digests for both inner proofs and, when it finished, the first
      shrink proof's flattened sha256.

Both are made again with

    python tests/test_torch_recursion.py --write [toy|fib]

which runs each heavy stage of zkm_tpu in a fresh process (XLA:CPU
segfaults compiling the shrink in a process that holds the inner proofs'
executables).  Each record takes about an hour on 8 CPU cores (the fib
one: inner proofs 544 + 639 s, DAG 122 s, shrink 1393 s): run it alone,
in the background.
"""

import copy
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from zkm_tpu import export as rexport  # noqa: E402
from zkm_tpu_torch.convert import (proof_from_plain, proof_to_plain,  # noqa: E402
                                   traces_from_rows)
from zkm_tpu_torch.emulator import state as estate  # noqa: E402
from zkm_tpu_torch.emulator import utils as eutils  # noqa: E402
from zkm_tpu_torch.export import export_proof_json, import_proof_json  # noqa: E402
from zkm_tpu_torch.fri.config import FriConfig  # noqa: E402
from zkm_tpu_torch.recursion import (ReplayFailure, evaluate,  # noqa: E402
                                     record_chain, record_verifier)
from zkm_tpu_torch.recursion.aggregate import (AggItem,  # noqa: E402
                                               AggregationTree,
                                               AssumptionProof)
from zkm_tpu_torch.recursion.cache import (  # noqa: E402
    build_shrink_circuit_cached, load_circuit, proof_shape_key, save_circuit)
from zkm_tpu_torch.recursion.shrink import (  # noqa: E402
    PROGRAM, ShrinkCircuit, build_program, build_shrink_circuit,
    generate_shrink_traces, make_shrink_ctls, make_shrink_starks,
    program_trace, prove_aggregation, prove_shrink, verify_shrink)
from zkm_tpu_torch.receipts import find_assumption  # noqa: E402
from zkm_tpu_torch.runtime.examples import build_fib_guest  # noqa: E402
from zkm_tpu_torch.stark.config import StarkConfig  # noqa: E402
from zkm_tpu_torch.stark.cross_table_lookup import (  # noqa: E402
    CrossTableLookup, TableWithColumns)
from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues,  # noqa: E402
                                       flatten_proof)
from zkm_tpu_torch.stark.prover import prove_with_traces  # noqa: E402
from zkm_tpu_torch.stark.verifier import verify_proof  # noqa: E402
from zkm_tpu_torch.tables import logic  # noqa: E402

CPU = "cpu"
DATA = os.path.join(ROOT, "zkm_tpu_torch", "data")
TOY_RECORD = os.path.join(DATA, "recursion_toy_reference.json")
FIB_RECORD = os.path.join(DATA, "recursion_fib_reference.json")

# the statements of tests/test_recursion_aggregate.py
OPS = [(0, 0x12345678, 0x0F0F0F0F),    # (logic.OP_AND, ...)
       (2, 0xDEADBEEF, 0xCAFEBABE),    # OP_XOR
       (3, 0xFFFFFFFF, 0x0)]           # OP_NOR
FIB_N, FIB_SEG_SIZE = 40, 1800
FIB_SUBSET = ("Cpu", "Logic", "Memory")


# ---------------------------------------------------------------------------
# Digests shared by the writer (on zkm_tpu's objects) and the tests (on the
# port's): both packages' DAGs and traces go through the same functions.
# ---------------------------------------------------------------------------

def op_key(e) -> tuple:
    """A DAG op with its hint function by name (`_HintBits` with its
    width), so ops compare across packages."""
    tag = e[0]
    if tag == 'h':
        fn = e[2]
        name = getattr(fn, "__name__", None) or \
            f"{type(fn).__name__}:{fn.nbits}"
        return ('h', tuple(int(w) for w in e[1]), name,
                tuple(int(w) for w in e[3]))
    if tag == 'p':
        return ('p', tuple(int(w) for w in e[1]),
                tuple(int(w) for w in e[2]))
    return (tag,) + tuple(int(x) for x in e[1:])


def _sha_lines(items) -> str:
    h = hashlib.sha256()
    for it in items:
        h.update(repr(it).encode())
        h.update(b"\n")
    return h.hexdigest()


def u64_sha256(values) -> str:
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


def dag_record(vdag) -> dict:
    dag = vdag.dag
    return {"n": int(dag.n), "prog_len": len(dag.prog),
            "num_poseidons": int(dag.num_poseidons),
            "num_public_inputs": int(vdag.num_public_inputs),
            "num_asserts": len(dag.asserts),
            "claim_wires": [int(w) for w in vdag.claim_wires],
            "prog_sha256": _sha_lines(op_key(e) for e in dag.prog),
            "asserts_sha256": _sha_lines((int(w), lbl)
                                         for w, lbl in dag.asserts)}


def traces_record(rows) -> list:
    """[(log2 height, num columns, sha256)] of (C, N) u64 traces."""
    return [{"log2_rows": int(r.shape[1]).bit_length() - 1,
             "columns": int(r.shape[0]), "sha256": u64_sha256(r)}
            for r in rows]


# ---------------------------------------------------------------------------
# The port on the CPU against the toy record.  The port's proofs of the two
# Logic statements are made here (seconds); the reference's shrink proofs
# and root come from the record, and what needs a program commitment or a
# shrink proof of the port on the CPU (many minutes of the plain Poseidon)
# is marked slow: chip_smoke.py phase 8a holds the same digests on the card.
# ---------------------------------------------------------------------------

P = (1 << 64) - (1 << 32) + 1


def rconfig() -> StarkConfig:
    """tests/test_recursion_aggregate.py:_rconfig: the aggregation DAG
    verifies two 5-table proofs, and its size is linear in the queries."""
    return StarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=FriConfig(rate_bits=2, cap_height=1,
                             proof_of_work_bits=1, num_query_rounds=2,
                             arity_bits=2, final_poly_bits=3))


def logic_system():
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    return [logic.LogicStark()], [CrossTableLookup(
        (TableWithColumns(0, cols, filt),), TableWithColumns(0, cols, filt))]


def toy_pv(tag_before: int, tag_after: int) -> PublicValues:
    return PublicValues(
        roots_before=MemRoots.from_image_id(bytes([tag_before] * 32)),
        roots_after=MemRoots.from_image_id(bytes([tag_after] * 32)),
        userdata=bytes(32))


def prove_toy(tag: int, device):
    """The toy statement with roots tag -> tag + 1."""
    starks, ctls = logic_system()
    rows = logic.generate_rows(OPS, min_rows=16)
    return prove_with_traces(starks, rconfig(), traces_from_rows([rows],
                                                                 device),
                             ctls, toy_pv(tag, tag + 1), device=device)


def flat_sha(proof) -> str:
    return u64_sha256(flatten_proof(proof))


def circuit_with_cap(vdag, config, cap) -> ShrinkCircuit:
    """The circuit `shrink._assemble_circuit` makes, with the verifying key
    taken from the record instead of committed to on the CPU (the slow
    test `test_program_cap_equals_reference` holds the port's own)."""
    prog = build_program(vdag.dag, vdag.claim_wires)
    return ShrinkCircuit(
        vdag=vdag, prog=prog, starks=make_shrink_starks(),
        ctls=make_shrink_ctls([int(w) for w in prog.claim_wires]),
        config=config, program_cap=np.asarray(cap, dtype=np.uint64))


def without(rec: dict, *keys) -> dict:
    return {k: v for k, v in rec.items() if k not in keys}


@pytest.fixture(scope="module")
def record():
    with open(TOY_RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def inner():
    """The port's proofs of the two toy statements (roots 0->1, 1->2)."""
    return [prove_toy(tag, CPU) for tag in (0, 1)]


@pytest.fixture(scope="module")
def shrink_circuit(inner, record):
    starks, ctls = logic_system()
    vdag = record_verifier(starks, ctls, rconfig(), inner[0])
    return circuit_with_cap(vdag, rconfig(),
                            record["shrink_circuit"]["program_cap"])


@pytest.fixture(scope="module")
def leaves(record):
    """zkm_tpu's two shrink proofs, read by the port's importer."""
    cap = np.asarray(record["shrink_circuit"]["program_cap"], dtype=np.uint64)
    return [AggItem(import_proof_json(s), cap)
            for s in record["shrink_proofs_json"]]


@pytest.fixture(scope="module")
def node_circuit(shrink_circuit, leaves, record):
    """The aggregation node's circuit, recorded by the port over zkm_tpu's
    leaves (its verifying key from the record)."""
    vdag = record_chain(shrink_circuit.starks, shrink_circuit.ctls,
                        rconfig(), [lf.proof for lf in leaves],
                        [{PROGRAM: lf.program_cap} for lf in leaves])
    return circuit_with_cap(vdag, rconfig(),
                            record["node_circuit"]["program_cap"])


@pytest.fixture(scope="module")
def tree(shrink_circuit):
    return AggregationTree(shrink_circuit, disk_cache=False, device=CPU)


def test_inner_proofs_equal_reference(inner, record):
    """The port's toy proofs: zkm_tpu's flattened sha256 and, through the
    port's export, zkm_tpu's JSON string; the JSON reads back to a proof
    that verifies."""
    starks, ctls = logic_system()
    for proof, sha, doc in zip(inner, record["inner_sha256_flat"],
                               record["inner_proofs_json"]):
        assert flat_sha(proof) == sha
        assert export_proof_json(proof, rconfig()) == doc
        back = import_proof_json(doc)
        assert flatten_proof(back) == flatten_proof(proof)
        verify_proof(starks, back, ctls, rconfig())


def test_reference_proof_reads_back_through_plain(record):
    """zkm_tpu's proof object, frozen as plain data and read back by
    convert.proof_from_plain, is the same proof to the port."""
    starks, ctls = logic_system()
    for doc, sha in zip(record["inner_proofs_json"],
                        record["inner_sha256_flat"]):
        ours = proof_from_plain(proof_to_plain(rexport.import_proof_json(doc)))
        assert flat_sha(ours) == sha
        assert proof_to_plain(ours)["public_values"] == \
            proof_to_plain(import_proof_json(doc))["public_values"]
        verify_proof(starks, ours, ctls, rconfig())


def test_shrink_dag_equals_reference(shrink_circuit, inner, record):
    """n, prog_len, num_poseidons, claim wires, every op (hints by name),
    every assertion, and every wire value on proof 0."""
    want = record["shrink_circuit"]
    vdag = shrink_circuit.vdag
    assert dag_record(vdag) == without(want, "wire_values_sha256",
                                       "program_cap", "traces")
    vals = evaluate(vdag.dag, flatten_proof(inner[0]))
    assert u64_sha256(vals) == want["wire_values_sha256"]


def test_dag_replays_proof_of_same_shape(shrink_circuit, inner):
    """Proof 1 (other roots, so other challenges) replays through the DAG
    recorded from proof 0 (zkm_tpu's test_dag_shape_reuse)."""
    evaluate(shrink_circuit.vdag.dag, flatten_proof(inner[1]))


def test_shrink_traces_equal_reference(shrink_circuit, inner, record):
    rows = generate_shrink_traces(shrink_circuit.vdag.dag,
                                  shrink_circuit.prog,
                                  flatten_proof(inner[0]))
    assert traces_record(rows) == record["shrink_circuit"]["traces"]
    assert (rows[PROGRAM] == program_trace(shrink_circuit.prog)).all()


def _tamper_opening(p):
    op = p.stark_proofs[0].proof.openings
    op.local_values[0][0] = (int(op.local_values[0][0]) + 1) % P


def _tamper_cap(p):
    cap = p.stark_proofs[0].proof.trace_cap
    cap[0][0] = (int(cap[0][0]) + 1) % P


def _tamper_ctl_z(p):
    op = p.stark_proofs[0].proof.openings
    op.ctl_zs_first[0] = (int(op.ctl_zs_first[0]) + 1) % P


def _tamper_root(p):
    p.public_values.roots_before.root[0] = \
        (int(p.public_values.roots_before.root[0]) + 1) % P


TAMPERS = {"opening": _tamper_opening, "cap": _tamper_cap,
           "ctl_z": _tamper_ctl_z, "public_value": _tamper_root}


@pytest.mark.parametrize("what", sorted(TAMPERS))
def test_dag_rejects_tampered_inner_proof(shrink_circuit, inner, what):
    """zkm_tpu's test_recursion_dag rejections and test_recursion_shrink's
    test_shrink_witness_rejects_invalid_inner: the shrink witness fails in
    DAG replay."""
    bad = copy.deepcopy(inner[0])
    TAMPERS[what](bad)
    with pytest.raises(ReplayFailure):
        generate_shrink_traces(shrink_circuit.vdag.dag, shrink_circuit.prog,
                               flatten_proof(bad))


def test_verify_shrink_accepts_reference_leaves(shrink_circuit, leaves,
                                                inner):
    """zkm_tpu's shrink proofs verify under the port's circuit and carry
    the inner claims."""
    for leaf, p in zip(leaves, inner):
        verify_shrink(shrink_circuit, leaf.proof)
        assert leaf.proof.public_values == p.public_values


def test_shrink_rejects_wrong_vk(shrink_circuit, leaves):
    bad = copy.copy(shrink_circuit)
    bad.program_cap = shrink_circuit.program_cap.copy()
    bad.program_cap[0][0] ^= 1
    with pytest.raises(ValueError, match="verifying key"):
        verify_shrink(bad, leaves[0].proof)


@pytest.mark.parametrize("what", ["claim", "opening"])
def test_shrink_rejects_tampered_proof(shrink_circuit, leaves, what):
    bad = copy.deepcopy(leaves[0].proof)
    if what == "claim":
        _tamper_root(bad)
    else:
        _tamper_opening(bad)
    with pytest.raises(ValueError):
        verify_shrink(shrink_circuit, bad)


def test_aggregation_dag_equals_reference(node_circuit, leaves, record):
    want = record["node_circuit"]
    assert dag_record(node_circuit.vdag) == without(
        want, "wire_values_sha256", "program_cap")
    pubs = flatten_proof(leaves[0].proof) + flatten_proof(leaves[1].proof)
    assert u64_sha256(evaluate(node_circuit.vdag.dag, pubs)) == \
        want["wire_values_sha256"]


def test_reference_root_verifies_with_combined_claim(node_circuit, leaves,
                                                     record):
    """zkm_tpu's root verifies under the port's node circuit and claims
    (leaf 0's roots_before, leaf 1's roots_after); a tampered claim is
    rejected."""
    root = import_proof_json(record["root_proof_json"])
    assert flat_sha(root) == record["root_sha256_flat"]
    verify_shrink(node_circuit, root)
    pv = root.public_values
    assert pv.roots_before == leaves[0].proof.public_values.roots_before
    assert pv.roots_after == leaves[1].proof.public_values.roots_after
    _tamper_root(root)
    with pytest.raises(ValueError):
        verify_shrink(node_circuit, root)


def test_aggregation_rejects_broken_continuation(node_circuit, leaves):
    """Children whose claims do not chain (1->2 before 0->1) fail in DAG
    replay, before anything is proved."""
    with pytest.raises(ReplayFailure, match="roots_after != roots_before"):
        prove_aggregation(node_circuit, [leaves[1].proof, leaves[0].proof],
                          device=CPU)


def test_aggregation_rejects_wrong_child_vk(node_circuit, leaves):
    """A child whose program table differs from the pinned verifying key
    fails the in-DAG cap pin in replay."""
    bad = copy.deepcopy(leaves[1].proof)
    cap = bad.stark_proofs[PROGRAM].proof.trace_cap
    cap[0][0] = int(cap[0][0]) ^ 1
    with pytest.raises(ReplayFailure, match="vk cap"):
        prove_aggregation(node_circuit, [leaves[0].proof, bad], device=CPU)


# -- composition at recursion level (tests/test_recursion_composition.py):
# leaf 0 is the program, leaf 1 the assumption --------------------------------

def test_composite_block_receipt_verifies(tree, leaves):
    ap = AssumptionProof(leaves[1])
    pv = leaves[1].proof.public_values
    assert ap.claim_digest() == hashlib.sha256(
        pv.roots_before.to_image_id() + pv.userdata).digest()
    tree.verify_block_receipt(tree.compose_block(leaves[0], [ap]))


def test_tampered_assumption_claim_rejected(tree, leaves):
    receipt = tree.compose_block(leaves[0], [AssumptionProof(leaves[1])])
    claim, proof = receipt.assumptions[0]
    receipt.assumptions[0] = (bytes([claim[0] ^ 1]) + claim[1:], proof)
    with pytest.raises(ValueError, match="claim digest"):
        tree.verify_block_receipt(receipt)


def test_tampered_assumption_proof_rejected(tree, leaves):
    bad = copy.deepcopy(leaves[1])
    bad.proof.public_values.userdata = bytes([1] * 32)
    receipt = tree.compose_block(leaves[0], [AssumptionProof(bad)])
    with pytest.raises(ValueError):
        tree.verify_block_receipt(receipt)


def test_foreign_verifying_key_rejected(tree, leaves):
    foreign = copy.deepcopy(leaves[1])
    foreign.program_cap = np.asarray(foreign.program_cap).copy()
    foreign.program_cap.flat[0] ^= 1
    receipt = tree.compose_block(leaves[0], [AssumptionProof(foreign)])
    with pytest.raises(KeyError, match="foreign program cap"):
        tree.verify_block_receipt(receipt)


def test_assumption_proof_resolves_in_witness_env(leaves):
    ap = AssumptionProof(leaves[1])
    assert find_assumption(ap.claim_digest(), [ap]) is ap
    with pytest.raises(KeyError):
        find_assumption(bytes(32), [ap])


def test_prove_block_genesis_passes_through(tree, leaves):
    assert tree.prove_block(None, leaves[0]) is leaves[0]


# -- the circuit cache ---------------------------------------------------------

def test_circuit_cache_round_trip(shrink_circuit, inner, tmp_path):
    """A saved circuit loads with its DAG, program and verifying key, and
    replays to the same traces."""
    path = str(tmp_path / "c.pkl")
    save_circuit(shrink_circuit, path)
    loaded = load_circuit(path)
    assert dag_record(loaded.vdag) == dag_record(shrink_circuit.vdag)
    assert (loaded.program_cap == shrink_circuit.program_cap).all()
    pubs = flatten_proof(inner[0])
    for a, b in zip(generate_shrink_traces(loaded.vdag.dag, loaded.prog,
                                           pubs),
                    generate_shrink_traces(shrink_circuit.vdag.dag,
                                           shrink_circuit.prog, pubs)):
        assert (a == b).all()


def test_tree_loads_node_circuit_from_its_cache_dir(shrink_circuit,
                                                    node_circuit, leaves,
                                                    record, tmp_path):
    """AggregationTree(disk_cache=True) finds a node circuit another process
    saved in its cache_dir (and records nothing)."""
    tree = AggregationTree(shrink_circuit, cache_dir=str(tmp_path),
                           device=CPU)
    key = (leaves[0].key(), leaves[1].key())
    save_circuit(node_circuit, tree._node_path(key))
    got = tree.node_circuit(leaves[0], leaves[1])
    assert dag_record(got.vdag) == dag_record(node_circuit.vdag)
    root = import_proof_json(record["root_proof_json"])
    verify_shrink(tree.circuit_for(AggItem(root, got.program_cap)), root)


def test_cached_build_hits_disk(shrink_circuit, inner, tmp_path):
    """build_shrink_circuit_cached loads the circuit saved under its shape
    key in `cache_dir` instead of recording and committing again."""
    starks, ctls = logic_system()
    key = proof_shape_key(starks, ctls, rconfig(), inner[0])
    save_circuit(shrink_circuit, str(tmp_path / f"shrink_{key}.pkl"))
    got = build_shrink_circuit_cached(starks, ctls, rconfig(), inner[0],
                                      cache_dir=str(tmp_path), device=CPU)
    assert dag_record(got.vdag) == dag_record(shrink_circuit.vdag)
    assert (got.program_cap == shrink_circuit.program_cap).all()


def test_shape_key_sensitivity(inner):
    starks, ctls = logic_system()
    k1 = proof_shape_key(starks, ctls, rconfig(), inner[0])
    assert k1 != proof_shape_key(starks, ctls,
                                 StarkConfig.standard_fast_config(), inner[0])
    assert k1 != proof_shape_key(starks, ctls, rconfig(), inner[0],
                                 tag="vkpins")


# -- the main path's segments (recursion_fib_reference.json) -------------------

def test_fib_segments_equal_reference():
    """fib(40) at seg_size 1800 through the port's emulator: the segments
    that chip_smoke.py phase 8b proves and shrinks."""
    with open(FIB_RECORD) as f:
        want = json.load(f)
    st = estate.State(CPU)
    st.memory.set_memory_range(0, build_fib_guest(FIB_N))
    total, segs, _ = eutils.split_prog_into_segs(st, seg_size=FIB_SEG_SIZE)
    assert total == want["total_steps"]
    assert [{"step": s.step, "pre_image_id": s.pre_image_id.hex(),
             "image_id": s.image_id.hex()} for s in segs] == want["segments"]


# -- slow: the port's own program commitment and shrink proof on the CPU ------

@pytest.mark.slow
def test_program_cap_equals_reference(inner, record):
    """build_shrink_circuit on the CPU: the verifying key is zkm_tpu's."""
    starks, ctls = logic_system()
    circuit = build_shrink_circuit(starks, ctls, rconfig(), inner[0],
                                   device=CPU)
    assert circuit.program_cap.tolist() == \
        record["shrink_circuit"]["program_cap"]


@pytest.mark.slow
def test_shrink_of_reference_proof_equals_reference(shrink_circuit, record):
    """zkm_tpu's toy proof, read back through convert.proof_from_plain,
    shrinks in the port to zkm_tpu's digest."""
    ref = proof_from_plain(proof_to_plain(
        rexport.import_proof_json(record["inner_proofs_json"][0])))
    sp = prove_shrink(shrink_circuit, ref, device=CPU)
    assert [pm.degree_bits for pm in sp.stark_proofs] == \
        record["shrink_heights_log2"][0]
    assert flat_sha(sp) == record["shrink_sha256_flat"][0]
    verify_shrink(shrink_circuit, sp)


# ---------------------------------------------------------------------------
# The writer.  Each stage runs in its own process and leaves a pickle in
# the work directory for the next.
# ---------------------------------------------------------------------------

def _clear_caches_per_table():
    """XLA:CPU segfaults compiling once a process holds many large
    executables; drop them before each table (no effect on values)."""
    import jax
    from zkm_tpu.stark import prover as rprover
    prove_table = rprover.prove_single_table

    def prove_table_after_clearing(*args, **kwargs):
        jax.clear_caches()
        return prove_table(*args, **kwargs)
    rprover.prove_single_table = prove_table_after_clearing


def _machine() -> str:
    return f"{os.cpu_count()}-core CPU, JAX's CPU backend"


def _ref_flat_sha(proof) -> str:
    from zkm_tpu.recursion import flatten_proof
    return u64_sha256(flatten_proof(proof))


def _ref_rconfig():
    from zkm_tpu.fri.config import FriConfig
    from zkm_tpu.stark.config import StarkConfig
    return StarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=FriConfig(rate_bits=2, cap_height=1,
                             proof_of_work_bits=1, num_query_rounds=2,
                             arity_bits=2, final_poly_bits=3))


def _ref_logic_system():
    from zkm_tpu.stark.cross_table_lookup import (CrossTableLookup,
                                                  TableWithColumns)
    from zkm_tpu.tables import logic
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    return [logic.LogicStark()], [CrossTableLookup(
        (TableWithColumns(0, cols, filt),), TableWithColumns(0, cols, filt))]


def _ref_pv(tag_before, tag_after):
    from zkm_tpu.stark.proof import MemRoots, PublicValues
    return PublicValues(
        roots_before=MemRoots.from_image_id(bytes([tag_before] * 32)),
        roots_after=MemRoots.from_image_id(bytes([tag_after] * 32)),
        userdata=bytes(32))


def _ref_shrink_rows(circuit, pubs):
    from zkm_tpu.field import goldilocks as rgl
    from zkm_tpu.recursion.shrink import generate_shrink_traces
    return [rgl.to_u64(t) for t in generate_shrink_traces(
        circuit.vdag.dag, circuit.prog, pubs)]


def _ref_circuit_record(circuit, pubs) -> dict:
    """The DAG's record, its wire values on `pubs` and the program cap."""
    from zkm_tpu.recursion import evaluate
    rec = dag_record(circuit.vdag)
    rec["wire_values_sha256"] = u64_sha256(
        np.asarray(evaluate(circuit.vdag.dag, pubs), dtype=np.uint64))
    rec["program_cap"] = [[int(v) for v in row]
                          for row in np.asarray(circuit.program_cap)]
    return rec


def stage_toy_shrink(work):
    from zkm_tpu.export import export_proof_json
    from zkm_tpu.recursion import flatten_proof
    from zkm_tpu.recursion.shrink import (build_shrink_circuit, prove_shrink,
                                          verify_shrink)
    from zkm_tpu.stark.prover import prove_with_traces
    from zkm_tpu.stark.verifier import verify_proof
    from zkm_tpu.tables import logic
    _clear_caches_per_table()
    config = _ref_rconfig()
    starks, ctls = _ref_logic_system()
    t0 = time.perf_counter()
    inner = []
    for tag in (0, 1):
        trace = logic.generate_trace(OPS, min_rows=16)
        p = prove_with_traces(starks, config, [trace], ctls,
                              _ref_pv(tag, tag + 1))
        verify_proof(starks, p, ctls, config)
        inner.append(p)
    inner_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    circuit = build_shrink_circuit(starks, ctls, config, inner[0])
    record_s = time.perf_counter() - t0
    circ = _ref_circuit_record(circuit, flatten_proof(inner[0]))
    circ["traces"] = traces_record(
        _ref_shrink_rows(circuit, flatten_proof(inner[0])))
    t0 = time.perf_counter()
    shrunk = []
    for p in inner:
        sp = prove_shrink(circuit, p)
        verify_shrink(circuit, sp)
        shrunk.append(sp)
    shrink_s = time.perf_counter() - t0
    out = {
        "ops": [list(o) for o in OPS], "min_rows": 16,
        "config": "tests/test_recursion_aggregate.py:_rconfig",
        "inner_proofs_json": [export_proof_json(p, config) for p in inner],
        "inner_sha256_flat": [_ref_flat_sha(p) for p in inner],
        "shrink_circuit": circ,
        "shrink_heights_log2": [[int(pm.degree_bits)
                                 for pm in sp.stark_proofs]
                                for sp in shrunk],
        "shrink_sha256_flat": [_ref_flat_sha(sp) for sp in shrunk],
        "shrink_export_sha256": hashlib.sha256(export_proof_json(
            shrunk[0], config, circuit.program_cap).encode()).hexdigest(),
        "reference_seconds": {"inner_proofs": round(inner_s, 1),
                              "record_dag": round(record_s, 1),
                              "two_shrinks": round(shrink_s, 1)},
    }
    with open(os.path.join(work, "toy_shrink.pkl"), "wb") as f:
        pickle.dump({"record": out, "shrunk": shrunk, "inner": inner}, f)


def stage_toy_root(work):
    from zkm_tpu.export import export_proof_json
    from zkm_tpu.recursion import flatten_proof
    from zkm_tpu.recursion.aggregate import AggItem, AggregationTree
    from zkm_tpu.recursion.shrink import build_shrink_circuit
    _clear_caches_per_table()
    with open(os.path.join(work, "toy_shrink.pkl"), "rb") as f:
        state = pickle.load(f)
    config = _ref_rconfig()
    starks, ctls = _ref_logic_system()
    circuit = build_shrink_circuit(starks, ctls, config, state["inner"][0])
    tree = AggregationTree(circuit, disk_cache=False)
    leaves = [AggItem(sp, circuit.program_cap) for sp in state["shrunk"]]
    t0 = time.perf_counter()
    node = tree.node_circuit(leaves[0], leaves[1])
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    root = tree.aggregate(leaves)
    root_s = time.perf_counter() - t0
    out = state["record"]
    out["node_circuit"] = _ref_circuit_record(
        node, flatten_proof(leaves[0].proof) + flatten_proof(leaves[1].proof))
    out["root_heights_log2"] = [int(pm.degree_bits)
                                for pm in root.proof.stark_proofs]
    out["root_sha256_flat"] = _ref_flat_sha(root.proof)
    # the proofs themselves, for the CPU tests that verify them, compose
    # them and aggregate them in DAG replay without proving
    out["shrink_proofs_json"] = [
        export_proof_json(sp, config, circuit.program_cap)
        for sp in state["shrunk"]]
    out["root_proof_json"] = export_proof_json(root.proof, config,
                                               node.program_cap)
    out["reference_seconds"].update(record_node_dag=round(record_s, 1),
                                    root=round(root_s, 1))
    out["reference_machine"] = _machine()
    _dump(TOY_RECORD, out)


def _ref_fib_system():
    from zkm_tpu.stark.all_stark import Table, make_all_stark
    from zkm_tpu.stark.config import StarkConfig
    return StarkConfig.test_config(), make_all_stark(
        tuple(getattr(Table, n) for n in FIB_SUBSET))


def stage_fib_inner(work):
    from zkm_tpu.emulator.state import State
    from zkm_tpu.emulator.utils import split_prog_into_segs
    from zkm_tpu.host import prove_segment, verify_segment_receipt
    from zkm_tpu.runtime.examples import build_fib_guest
    _clear_caches_per_table()
    config, all_stark = _ref_fib_system()
    state = State()
    state.memory.set_memory_range(0, build_fib_guest(FIB_N))
    total, segs, _ = split_prog_into_segs(state, None, "",
                                          seg_size=FIB_SEG_SIZE)
    receipts, seconds = [], []
    for seg in segs[:2]:
        t0 = time.perf_counter()
        r = prove_segment(seg, config, all_stark)
        seconds.append(round(time.perf_counter() - t0, 1))
        verify_segment_receipt(r, config, all_stark)
        receipts.append(r)
    out = {
        "guest": f"runtime.examples.build_fib_guest({FIB_N})",
        "seg_size": FIB_SEG_SIZE, "subset": list(FIB_SUBSET),
        "config": "test_config", "total_steps": int(total),
        "segments": [{"step": int(s.step),
                      "pre_image_id": s.pre_image_id.hex(),
                      "image_id": s.image_id.hex()} for s in segs],
        "inner_heights_log2": [[int(pm.degree_bits)
                                for pm in r.proof.stark_proofs]
                               for r in receipts],
        "inner_sha256_flat": [_ref_flat_sha(r.proof) for r in receipts],
        "reference_seconds": {"inner_proofs": seconds},
        "reference_machine": _machine(),
    }
    with open(os.path.join(work, "fib_inner.pkl"), "wb") as f:
        pickle.dump({"record": out,
                     "proofs": [r.proof for r in receipts]}, f)
    _dump(FIB_RECORD, out)


def stage_fib_dag(work):
    from zkm_tpu.recursion import flatten_proof
    from zkm_tpu.recursion.cache import save_circuit
    from zkm_tpu.recursion.shrink import build_shrink_circuit
    with open(os.path.join(work, "fib_inner.pkl"), "rb") as f:
        state = pickle.load(f)
    config, all_stark = _ref_fib_system()
    proofs = state["proofs"]
    t0 = time.perf_counter()
    circuit = build_shrink_circuit(all_stark.starks, all_stark.ctls, config,
                                   proofs[0])
    record_s = time.perf_counter() - t0
    save_circuit(circuit, os.path.join(work, "fib_circuit.pkl"))
    out = state["record"]
    out["shrink_circuit"] = _ref_circuit_record(circuit,
                                                flatten_proof(proofs[0]))
    out["shrink_traces"] = [traces_record(
        _ref_shrink_rows(circuit, flatten_proof(p))) for p in proofs]
    out["reference_seconds"]["record_dag"] = round(record_s, 1)
    out["shrink_sha256_flat"] = None
    out["shrink_note"] = "zkm_tpu's shrink proof of segment 0 not run yet"
    _dump(FIB_RECORD, out)


def stage_fib_shrink(work):
    from zkm_tpu.recursion.cache import load_circuit
    from zkm_tpu.recursion.shrink import prove_shrink, verify_shrink
    _clear_caches_per_table()
    with open(os.path.join(work, "fib_inner.pkl"), "rb") as f:
        proofs = pickle.load(f)["proofs"]
    circuit = load_circuit(os.path.join(work, "fib_circuit.pkl"))
    t0 = time.perf_counter()
    sp = prove_shrink(circuit, proofs[0])
    seconds = time.perf_counter() - t0
    verify_shrink(circuit, sp)
    with open(FIB_RECORD) as f:
        out = json.load(f)
    out["shrink_heights_log2"] = [int(pm.degree_bits)
                                  for pm in sp.stark_proofs]
    out["shrink_sha256_flat"] = _ref_flat_sha(sp)
    out["shrink_note"] = "zkm_tpu's shrink proof of segment 0"
    out["reference_seconds"]["shrink_0"] = round(seconds, 1)
    _dump(FIB_RECORD, out)


STAGES = {"toy_shrink": stage_toy_shrink, "toy_root": stage_toy_root,
          "fib_inner": stage_fib_inner, "fib_dag": stage_fib_dag,
          "fib_shrink": stage_fib_shrink}
CHAINS = {"toy": [("toy_shrink", 5400), ("toy_root", 5400)],
          "fib": [("fib_inner", 5400), ("fib_dag", 3600),
                  ("fib_shrink", 7200)]}


def _dump(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {path}", flush=True)


def write(chains) -> None:
    """Each stage in a fresh process with its time limit; a fib shrink
    that does not finish leaves the record saying so."""
    work = tempfile.mkdtemp(prefix="recursion_write_")
    for chain in chains:
        for name, limit in CHAINS[chain]:
            t0 = time.perf_counter()
            try:
                rc = subprocess.run([sys.executable, __file__, "--stage",
                                     name, work], timeout=limit).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            print(f"stage {name}: rc={rc} in "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
            if rc != 0:
                if name == "fib_shrink" and os.path.exists(FIB_RECORD):
                    with open(FIB_RECORD) as f:
                        out = json.load(f)
                    out["shrink_note"] = (
                        f"zkm_tpu's shrink proof of segment 0 did not "
                        f"finish (rc={rc}, limit {limit} s, "
                        f"{_machine()})")
                    _dump(FIB_RECORD, out)
                break


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stage"]:
        STAGES[sys.argv[2]](sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] != ["--write"]:
        sys.exit(__doc__)
    write(sys.argv[2:] or ["toy", "fib"])
