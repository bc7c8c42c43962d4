"""A segment's witness: what the per-table trace builders consume.

The fields of zkm_tpu/witness/generation.py's `TraceSet` that the 12
tables read, a frozen-file format for them, the CPU table's padding and
digests of a whole witness.  A `TraceSet` comes from witness
generation (witness/generation.py) or from a file (`load_npz`).

The npz holds integer arrays only:
  cpu_rows             (n, 260) u64, natural height (ends in pad rows)
  memory_ops           (k, 7) u64: filter, timestamp, is_read, context,
                       segment, virt, value
  arith_ops            (k, 4) u64: flag, in0, in1, result
  logic_ops            (k, 3) u64: op, in0, in1
  poseidon_inputs      (k, 13) u64: 12 input elements, timestamp
  sponge_timestamps    (s,) u64
  sponge_input         concatenated input bytes (u8), split at
  sponge_input_offsets (s + 1,) u64
  sponge_addresses     (a, 3) u64 (context, segment, virt), split at
  sponge_address_offsets (s + 1,) u64
  keccak_inputs        (k, 26) u64: 25 lanes (A[x + 5y]), timestamp
  keccak_sponge_*      the keccak sponge ops, as the five sponge_* arrays
  sha_extend_ops       (k, 9) u64: context, segment, virt_out, timestamp,
                       4 inputs, output
  sha_compress_ops     (k, 85) u64: context, segment, h_virt, w_virt_base,
                       timestamp, hx (8), w (64), final (8)
A file written before the Keccak and SHA fields existed loads with them
empty.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..stark.proof import MemRoots, PublicValues
from ..tables import arithmetic as arith
from ..tables.cpu import columns as cc
from ..tables.keccak_sponge import KeccakSpongeOp
from ..tables.memory import MemoryOp
from ..tables.poseidon_sponge import PoseidonSpongeOp
from ..tables.sha_compress import ShaCompressOp
from ..tables.sha_extend import ShaExtendOp


DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
# bench._toy_segment()'s witness at natural heights, and zkm_tpu's record
# of its SPONGE_SUBSET proof (public values, heights, flattened sha256);
# both written by `python tests/test_torch_segment.py --write`
TOY_WITNESS = os.path.join(DATA, "toy_segment_witness.npz")
TOY_REFERENCE = os.path.join(DATA, "toy_segment_reference.json")


@dataclass
class TraceSet:
    """Everything the trace builders consume."""
    cpu_rows: np.ndarray                 # (n, NUM_CPU_COLUMNS) uint64
    memory_ops: List[MemoryOp] = field(default_factory=list)
    arith_ops: List[arith.Op] = field(default_factory=list)
    logic_ops: List[Tuple[int, int, int]] = field(default_factory=list)
    poseidon_inputs: List[Tuple[List[int], int]] = field(default_factory=list)
    poseidon_sponge_ops: List[PoseidonSpongeOp] = field(default_factory=list)
    keccak_inputs: List[Tuple[List[int], int]] = field(default_factory=list)
    keccak_sponge_ops: List[KeccakSpongeOp] = field(default_factory=list)
    sha_extend_ops: List[ShaExtendOp] = field(default_factory=list)
    sha_compress_ops: List[ShaCompressOp] = field(default_factory=list)
    # SYS_VERIFY's claim digests and the [(Assumption, AssumptionReceipt)]
    # they resolved to (not part of the npz: no table reads them)
    claim_digests: List[bytes] = field(default_factory=list)
    assumptions_used: List[tuple] = field(default_factory=list)


def pad_cpu_rows(rows: np.ndarray, min_rows: int) -> np.ndarray:
    """(n, C) CPU rows that end in an exit-kernel pad row -> rows padded to
    the next power of two >= max(n, min_rows) with copies of that row, each
    with CLOCK set to its row index (zkm_tpu/witness/generation.py's
    padding, zkMIPS generation/mod.rs:169-185)."""
    n = len(rows)
    assert rows[-1, cc.IS_EXIT_KERNEL] == 1, "rows must end in a pad row"
    m = 1 << (max(n, min_rows) - 1).bit_length()
    if m == n:
        return rows
    pad = np.repeat(rows[-1:], m - n, axis=0)
    pad[:, cc.CLOCK] = np.arange(n, m, dtype=np.uint64)
    return np.concatenate([rows, pad])


def _split(flat: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    return [flat[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def _offsets(lengths) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths, dtype=np.uint64)]).astype(
        np.uint64)


def _pack_sponge(prefix: str, ops) -> dict:
    """A byte sponge's ops (PoseidonSpongeOp or KeccakSpongeOp) as arrays."""
    u64 = np.uint64
    return {
        prefix + "timestamps": np.array([op.timestamp for op in ops],
                                        dtype=u64),
        prefix + "input": np.frombuffer(b"".join(op.input for op in ops),
                                        dtype=np.uint8),
        prefix + "input_offsets": _offsets([len(op.input) for op in ops]),
        prefix + "addresses": np.array([a for op in ops
                                        for a in op.base_address],
                                       dtype=u64).reshape(-1, 3),
        prefix + "address_offsets": _offsets([len(op.base_address)
                                              for op in ops])}


def _unpack_sponge(prefix: str, d: dict, op_type) -> list:
    if prefix + "timestamps" not in d:
        return []
    return [op_type(base_address=[tuple(int(v) for v in a) for a in addrs],
                    timestamp=int(t), input=inp.tobytes())
            for t, inp, addrs in zip(
                d[prefix + "timestamps"],
                _split(d[prefix + "input"], d[prefix + "input_offsets"]),
                _split(d[prefix + "addresses"],
                       d[prefix + "address_offsets"]))]


def pack(ts) -> dict:
    """The npz's arrays of a TraceSet (of either package)."""
    u64 = np.uint64
    return dict(
        cpu_rows=np.asarray(ts.cpu_rows, dtype=u64),
        memory_ops=np.array(
            [(op.filter, op.timestamp, op.is_read, op.context, op.segment,
              op.virt, op.value) for op in ts.memory_ops],
            dtype=u64).reshape(-1, 7),
        arith_ops=np.array([(op.flag, op.in0, op.in1, op.result)
                            for op in ts.arith_ops], dtype=u64).reshape(-1, 4),
        logic_ops=np.array(ts.logic_ops, dtype=u64).reshape(-1, 3),
        poseidon_inputs=np.array([list(inp) + [ts_] for inp, ts_ in
                                  ts.poseidon_inputs],
                                 dtype=u64).reshape(-1, 13),
        **_pack_sponge("sponge_", ts.poseidon_sponge_ops),
        keccak_inputs=np.array([[int(v) for v in inp] + [ts_] for inp, ts_ in
                                ts.keccak_inputs], dtype=u64).reshape(-1, 26),
        **_pack_sponge("keccak_sponge_", ts.keccak_sponge_ops),
        sha_extend_ops=np.array(
            [[op.context, op.segment, op.virt_out, op.timestamp, *op.inputs,
              op.output] for op in ts.sha_extend_ops],
            dtype=u64).reshape(-1, 9),
        sha_compress_ops=np.array(
            [[op.context, op.segment, op.h_virt, op.w_virt_base,
              op.timestamp, *op.hx, *op.w, *op.final]
             for op in ts.sha_compress_ops], dtype=u64).reshape(-1, 85))


def save_npz(path: str, ts: TraceSet) -> None:
    np.savez_compressed(path, **pack(ts))


def field_digests(ts) -> dict:
    """{npz array name: sha256 hex of its dtype, shape and bytes}: a whole
    witness in a few hundred bytes."""
    out = {}
    for name, arr in pack(ts).items():
        arr = np.ascontiguousarray(arr)
        h = hashlib.sha256(f"{arr.dtype.str} {arr.shape} ".encode())
        h.update(arr.tobytes())
        out[name] = h.hexdigest()
    return out


def load_npz(path: str) -> TraceSet:
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    ints = lambda row: [int(v) for v in row]  # noqa: E731
    rows = lambda name, width: d.get(  # noqa: E731
        name, np.zeros((0, width), np.uint64))
    return TraceSet(
        cpu_rows=d["cpu_rows"],
        memory_ops=[MemoryOp(bool(f), t, bool(r), c, s, v, x)
                    for f, t, r, c, s, v, x in map(ints, d["memory_ops"])],
        arith_ops=[arith.Op(*ints(row)) for row in d["arith_ops"]],
        logic_ops=[tuple(ints(row)) for row in d["logic_ops"]],
        poseidon_inputs=[(ints(row[:12]), int(row[12]))
                         for row in d["poseidon_inputs"]],
        poseidon_sponge_ops=_unpack_sponge("sponge_", d, PoseidonSpongeOp),
        keccak_inputs=[(ints(row[:25]), int(row[25]))
                       for row in rows("keccak_inputs", 26)],
        keccak_sponge_ops=_unpack_sponge("keccak_sponge_", d,
                                         KeccakSpongeOp),
        sha_extend_ops=[ShaExtendOp(*row[:4], row[4:8], row[8])
                        for row in map(ints, rows("sha_extend_ops", 9))],
        sha_compress_ops=[
            ShaCompressOp(*row[:5], row[5:13], row[13:77], row[77:85])
            for row in map(ints, rows("sha_compress_ops", 85))])


def load_toy_segment():
    """(TraceSet, PublicValues, reference record) of the frozen toy
    segment."""
    with open(TOY_REFERENCE) as f:
        ref = json.load(f)
    pv = ref["public_values"]
    return (load_npz(TOY_WITNESS),
            PublicValues(MemRoots(pv["roots_before"]),
                         MemRoots(pv["roots_after"]),
                         bytes.fromhex(pv["userdata"])),
            ref)
