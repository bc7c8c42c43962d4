"""A segment's witness: what the per-table trace builders consume.

The fields of zkm_tpu/witness/generation.py's `TraceSet` that the
SPONGE_SUBSET tables read, a frozen-file format for them, the CPU table's
padding and digests of a whole witness.  A `TraceSet` comes from witness
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
from ..tables.memory import MemoryOp
from ..tables.poseidon_sponge import PoseidonSpongeOp


DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
# bench._toy_segment()'s witness at natural heights, and zkm_tpu's record
# of its SPONGE_SUBSET proof (public values, heights, flattened sha256);
# both written by `python tests/test_torch_segment.py --write`
TOY_WITNESS = os.path.join(DATA, "toy_segment_witness.npz")
TOY_REFERENCE = os.path.join(DATA, "toy_segment_reference.json")


@dataclass
class TraceSet:
    """Everything the SPONGE_SUBSET trace builders consume."""
    cpu_rows: np.ndarray                 # (n, NUM_CPU_COLUMNS) uint64
    memory_ops: List[MemoryOp] = field(default_factory=list)
    arith_ops: List[arith.Op] = field(default_factory=list)
    logic_ops: List[Tuple[int, int, int]] = field(default_factory=list)
    poseidon_inputs: List[Tuple[List[int], int]] = field(default_factory=list)
    poseidon_sponge_ops: List[PoseidonSpongeOp] = field(default_factory=list)


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


def pack(ts) -> dict:
    """The npz's arrays of a TraceSet (of either package)."""
    u64 = np.uint64
    sponge = ts.poseidon_sponge_ops
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
        sponge_timestamps=np.array([op.timestamp for op in sponge], dtype=u64),
        sponge_input=np.frombuffer(b"".join(op.input for op in sponge),
                                   dtype=np.uint8),
        sponge_input_offsets=_offsets([len(op.input) for op in sponge]),
        sponge_addresses=np.array([a for op in sponge
                                   for a in op.base_address],
                                  dtype=u64).reshape(-1, 3),
        sponge_address_offsets=_offsets([len(op.base_address)
                                         for op in sponge]))


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
    sponge = [
        PoseidonSpongeOp(base_address=[tuple(ints(a)) for a in addrs],
                         timestamp=int(t), input=inp.tobytes())
        for t, inp, addrs in zip(
            d["sponge_timestamps"],
            _split(d["sponge_input"], d["sponge_input_offsets"]),
            _split(d["sponge_addresses"], d["sponge_address_offsets"]))]
    return TraceSet(
        cpu_rows=d["cpu_rows"],
        memory_ops=[MemoryOp(bool(f), t, bool(r), c, s, v, x)
                    for f, t, r, c, s, v, x in map(ints, d["memory_ops"])],
        arith_ops=[arith.Op(*ints(row)) for row in d["arith_ops"]],
        logic_ops=[tuple(ints(row)) for row in d["logic_ops"]],
        poseidon_inputs=[(ints(row[:12]), int(row[12]))
                         for row in d["poseidon_inputs"]],
        poseidon_sponge_ops=sponge)


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
