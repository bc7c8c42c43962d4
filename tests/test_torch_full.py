"""zkm_tpu_torch's whole FULL_SUBSET path (all 12 tables, 15 CTLs) against
zkm_tpu: the full guest's bytes, the whole witnesses of three guests that
call keccak and the SHA syscalls, the hash-heavy segment's frozen record,
and (slow) the full guest's proof against zkm_tpu's frozen digest.
Equality is exact (tolerance zero).

The two records in zkm_tpu_torch/data are made again with

    python tests/test_torch_full.py --write

which runs zkm_tpu's emulator, witness generation and trace builders on
`build_hash_guest()` (assembled by the port's SDK: zkm_tpu has no such
workload) and zkm_tpu's FULL_SUBSET proof of `build_full_guest()` under
standard_fast_config (many minutes on a CPU: run it alone, in a fresh
process).
"""

import hashlib
import json
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

from zkm_tpu import host as rhost  # noqa: E402
from zkm_tpu.emulator import utils as rutils  # noqa: E402
from zkm_tpu.recursion import flatten_proof as ref_flatten_proof  # noqa: E402
from zkm_tpu.runtime import examples as rexamples  # noqa: E402
from zkm_tpu.stark import all_stark as rall  # noqa: E402
from zkm_tpu.stark.config import StarkConfig as RefStarkConfig  # noqa: E402
from zkm_tpu.witness import generation as rgen  # noqa: E402
from zkm_tpu_torch import host  # noqa: E402
from zkm_tpu_torch.convert import proof_to_plain  # noqa: E402
from zkm_tpu_torch.emulator import utils  # noqa: E402
from zkm_tpu_torch.runtime import examples  # noqa: E402
from zkm_tpu_torch.stark.all_stark import FULL_SUBSET, make_all_stark  # noqa: E402
from zkm_tpu_torch.stark.config import StarkConfig  # noqa: E402
from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof  # noqa: E402
from zkm_tpu_torch.witness import generation, trace_set  # noqa: E402

sys.path.insert(0, HERE)
from test_full_system import build_full_guest as ref_build_full_guest  # noqa: E402
from test_torch_emulator import (_states, assert_trace_sets_equal,  # noqa: E402
                                 segment_record)
from test_torch_proof import to_reference  # noqa: E402

CPU = "cpu"
FULL_RECORD = os.path.join(trace_set.DATA, "full_segment_reference.json")
HASH_RECORD = os.path.join(trace_set.DATA, "hash_segment_reference.json")
HASH_SEG_SIZE = 1 << 16
KECCAK_GUEST_BYTES = 64

GUESTS = {
    # name: (program, input vectors, seg_size)
    "full": (examples.build_full_guest(), (), 1 << 20),
    "sha2": (examples.build_sha2_guest(), (bytes(range(32)),), 1 << 20),
    "keccak": (examples.build_keccak_guest(KECCAK_GUEST_BYTES),
               (bytes(range(100, 100 + KECCAK_GUEST_BYTES)),), 1 << 20),
    "hash": (examples.build_hash_guest(), (examples.hash_guest_input(),),
             HASH_SEG_SIZE),
}
_SPLITS = {}


def split(name):
    """(ours, reference): each (total steps, segments, final state)."""
    if name not in _SPLITS:
        prog, inputs, seg_size = GUESTS[name]
        ours, ref = _states(prog, inputs)
        _SPLITS[name] = (utils.split_prog_into_segs(ours, seg_size=seg_size),
                         rutils.split_prog_into_segs(ref, seg_size=seg_size))
    return _SPLITS[name]


def natural_heights(ts) -> list:
    """log2 heights of the 12 tables built from a witness, on the CPU."""
    rows = host.trace_set_traces(ts, make_all_stark(FULL_SUBSET), device=CPU)
    return [r.shape[1].bit_length() - 1 for r in rows]


def test_full_guest_bytes_equal_reference():
    assert examples.build_full_guest() == ref_build_full_guest()
    assert examples.build_keccak_guest(KECCAK_GUEST_BYTES) == \
        rexamples.build_keccak_guest(KECCAK_GUEST_BYTES)


@pytest.mark.parametrize("name", ["full", "sha2", "keccak"])
def test_whole_witness_matches_reference(name, tmp_path):
    """Every field of the witness, and its npz round trip."""
    (_, segs, _), (_, rsegs, _) = split(name)
    assert len(segs) == 1
    ours = generation.generate_segment_traces(
        segs[0], sponge=True, keccak=True, sha=True, device=CPU)
    ref = rgen.generate_segment_traces(rsegs[0], sponge=True, keccak=True,
                                       sha=True)
    assert ours.sha_extend_ops and ours.sha_compress_ops or name == "keccak"
    assert ours.keccak_inputs and ours.keccak_sponge_ops or name == "sha2"
    assert_trace_sets_equal(ours, ref)
    trace_set.save_npz(tmp_path / "w.npz", ours)
    assert_trace_sets_equal(trace_set.load_npz(tmp_path / "w.npz"), ref)


def test_full_guest_witness_matches_frozen_record():
    """The record chip_smoke.py phase 7a holds the card to: steps, image
    ids, public values and every field digest (its heights and digest are
    held by the slow proof test below and on the card)."""
    with open(FULL_RECORD) as f:
        record = json.load(f)
    (total, segs, _), _ = split("full")
    ts = generation.generate_segment_traces(segs[0], sponge=True, keccak=True,
                                            sha=True, device=CPU)
    want = record["segment"]
    assert (total, len(segs)) == (record["total_steps"], 1)
    assert segment_record(segs[0], ts, want["natural_heights_log2"]) == want


def test_hash_segment_matches_frozen_record():
    """The hash-heavy segment (chip_smoke.py phase 7b's) from its program
    bytes through the port on the CPU: steps, image ids, public values,
    the 12 natural heights and every field digest of its witness."""
    with open(HASH_RECORD) as f:
        record = json.load(f)
    assert sorted(record["segments"][0]["field_digests"]) == \
        sorted(trace_set.field_digests(trace_set.TraceSet(cpu_rows=[])))
    (total, segs, _), _ = split("hash")
    assert (total, len(segs)) == (record["total_steps"],
                                  record["num_segments"])
    for seg, want in zip(segs, record["segments"]):
        ts = generation.generate_segment_traces(seg, sponge=True, keccak=True,
                                                sha=True, device=CPU)
        assert segment_record(seg, ts, natural_heights(ts)) == want


@pytest.mark.slow
def test_full_segment_proof_matches_reference_digest():
    """The full guest's FULL_SUBSET proof on the CPU (minutes; on the card
    `chip_smoke.py` phase 7a runs it in every run), with debug=True."""
    from zkm_tpu.stark.verifier import verify_proof as ref_verify_proof
    with open(FULL_RECORD) as f:
        record = json.load(f)
    (_, segs, _), _ = split("full")
    all_stark = make_all_stark(FULL_SUBSET)
    config = StarkConfig.standard_fast_config()
    receipt = host.prove_segment(segs[0], config, all_stark, debug=True,
                                 device=CPU)
    proof = receipt.proof
    assert [p.degree_bits for p in proof.stark_proofs] == \
        record["segment"]["natural_heights_log2"]
    assert flat_sha256(flatten_proof(proof)) == record["sha256_flat"]
    host.verify_segment_receipt(receipt, config, all_stark)
    ref_all = rall.make_all_stark(rall.FULL_SUBSET)
    ref_verify_proof(ref_all.starks, to_reference(proof_to_plain(proof)),
                     ref_all.ctls, RefStarkConfig.standard_fast_config())


# ---------------------------------------------------------------------------
# The writer of the two records.
# ---------------------------------------------------------------------------

def _split_reference(name):
    from zkm_tpu.emulator import state as rstate
    prog, inputs, seg_size = GUESTS[name]
    st = rstate.State()
    st.memory.set_memory_range(0, prog)
    for raw in inputs:
        st.add_input_stream_bytes(raw)
    return rutils.split_prog_into_segs(st, seg_size=seg_size)


def _machine() -> str:
    return (f"{os.cpu_count()}-core CPU, zkm_tpu's pure-Python emulator, "
            "JAX's CPU backend")


def _dump(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: {json.dumps(record)[:1500]}", flush=True)


def write_hash_record() -> None:
    all_stark = rall.make_all_stark(rall.FULL_SUBSET)
    t0 = time.perf_counter()
    total, segs, _ = _split_reference("hash")
    split_s = time.perf_counter() - t0
    records, witness_s = [], []
    for seg in segs:
        t0 = time.perf_counter()
        ts = rgen.generate_segment_traces(seg, sponge=True, keccak=True,
                                          sha=True)
        witness_s.append(round(time.perf_counter() - t0, 1))
        traces = rhost.segment_traces(seg, all_stark)
        heights = [int(tr[0].shape[-1]).bit_length() - 1 for tr in traces]
        records.append(segment_record(seg, ts, heights))
    _dump(HASH_RECORD, {
        "guest": "runtime.examples.build_hash_guest() (zkm_tpu_torch's SDK)",
        "input": "runtime.examples.hash_guest_input()",
        "loaded_at": 0, "seg_size": HASH_SEG_SIZE,
        "subset": [t.name for t in rall.FULL_SUBSET],
        "total_steps": total, "num_segments": len(segs),
        "reference_split_seconds": round(split_s, 1),
        "reference_witness_seconds": witness_s,
        "reference_machine": _machine(),
        "segments": records})


def write_full_record() -> None:
    import jax
    from zkm_tpu.stark import prover as rprover
    total, segs, _ = _split_reference("full")
    assert len(segs) == 1
    seg = segs[0]
    ts = rgen.generate_segment_traces(seg, sponge=True, keccak=True, sha=True)
    # XLA:CPU segfaults compiling once a process holds many large
    # executables (tests/conftest.py:33-40); in one 12-table proof it did
    # so at the last table's lookup, so drop the compiled executables
    # before each table (compilation has no effect on the values)
    prove_table = rprover.prove_single_table

    def prove_table_after_clearing(*args, **kwargs):
        jax.clear_caches()
        return prove_table(*args, **kwargs)
    rprover.prove_single_table = prove_table_after_clearing
    t0 = time.perf_counter()
    try:
        receipt = rhost.prove_segment(
            seg, RefStarkConfig.standard_fast_config(),
            rall.make_all_stark(rall.FULL_SUBSET))
    finally:
        rprover.prove_single_table = prove_table
    seconds = time.perf_counter() - t0
    flat = ref_flatten_proof(receipt.proof)
    heights = [int(p.degree_bits) for p in receipt.proof.stark_proofs]
    _dump(FULL_RECORD, {
        "guest": "runtime.examples.build_full_guest() (zkm_tpu's "
                 "tests/test_full_system.py:build_full_guest)",
        "loaded_at": 0, "seg_size": GUESTS["full"][2],
        "config": "standard_fast_config",
        "subset": [t.name for t in rall.FULL_SUBSET],
        "total_steps": total,
        "segment": segment_record(seg, ts, heights),
        "num_flat_elements": len(flat),
        "sha256_flat": hashlib.sha256(b"".join(
            int(v).to_bytes(8, "little") for v in flat)).hexdigest(),
        "reference_prove_seconds": round(seconds, 1),
        "reference_prove_machine": _machine()})


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_hash_record()
    write_full_record()
