"""Host-facing proving API: ELF or program -> segments -> multi-table
proofs.

Counterpart of zkm_tpu/host.py (`SegmentReceipt`,
`public_values_for_segment`, `segment_traces`, `prove_segment`,
`verify_segment_receipt`, `check_receipt_chain`, `prove_elf`,
`prove_segments_with_assumptions`): execute and
split a program (emulator/), generate each segment's witness
(witness/generation.py), build the traces of a subset of the 12 tables
(SPONGE_SUBSET by default, FULL_SUBSET for all) and prove them.
A frozen witness goes in through `prove_trace_set`.  Every entry point
runs on the card unless it is given device="cpu", and raises without one.
A `timer` (utils.timing.StepTimer) collects per-step seconds: "emulate",
"witness", "trace_build" and the prover's steps.

With a `mesh` (parallel/sharding.py) every rank runs emulation, witness
generation and trace building itself (deterministic host work) and the
proof is spread over its tp group (stark/prover.py); `prove_segments`
gives each dp group its share of the segments and gathers the receipts.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .convert import traces_from_rows
from .device import resolve_device
from .emulator.state import Segment
from .emulator.utils import load_elf_with_patch, split_prog_into_segs
from .receipts import CompositeReceipt, InnerReceipt, Receipt, ReceiptClaim
from .stark.all_stark import AllStark, Table, make_all_stark
from .stark.config import StarkConfig
from .stark.proof import AllProof, MemRoots, PublicValues
from .stark.prover import prove_with_traces
from .stark.verifier import verify_proof
from .tables import arithmetic as arith
from .tables import keccak as keccak_tab
from .tables import keccak_sponge as ksponge
from .tables import logic
from .tables import memory as mem
from .tables import poseidon
from .tables import poseidon_sponge as psponge
from .tables import sha_compress as shac
from .tables import sha_compress_sponge as shacs
from .tables import sha_extend as shae
from .tables import sha_extend_sponge as shaes
from .utils.timing import step
from .witness.generation import generate_segment_traces
from .witness.trace_set import TraceSet, pad_cpu_rows


@dataclass
class SegmentReceipt:
    """Proof + public values for one segment (zkMIPS Receipt::Segments)."""
    proof: AllProof
    pre_image_id: bytes
    image_id: bytes
    userdata: bytes


def public_values_for_segment(seg: Segment) -> PublicValues:
    userdata = hashlib.sha256(
        seg.input_stream[0] if seg.input_stream else b"").digest()
    return PublicValues(
        roots_before=MemRoots.from_image_id(seg.pre_image_id),
        roots_after=MemRoots.from_image_id(seg.image_id),
        userdata=userdata)


def trace_set_traces(trace_set: TraceSet, all_stark: AllStark,
                     height_floors: Optional[Dict[Table, int]] = None,
                     device=None) -> List[np.ndarray]:
    """Per-table (C, N) u64 trace rows of the subset from a witness.

    height_floors: {Table: min_rows} degree buckets; unlisted tables pad to
    their natural power-of-two height (at least 64 rows, Arithmetic at
    least RANGE_MIN_ROWS, PoseidonSponge and KeccakSponge at least their
    MIN_ROWS, ShaCompress at least 128).  Padding rows
    are each table's own, so a proof stays valid at any floor.  The sponge
    chains of the PoseidonSponge builder run on the card unless
    device='cpu'."""
    floors = dict(height_floors or {})
    t = trace_set

    def floor_of(tab, default=64):
        return max(floors.get(tab, 0), default)

    builders = {
        Table.Arithmetic: lambda f: arith.generate_rows(
            t.arith_ops, min_rows=max(f, arith.RANGE_MIN_ROWS)),
        Table.Cpu: lambda f: pad_cpu_rows(t.cpu_rows, f).T.copy(),
        Table.Poseidon: lambda f: poseidon.generate_rows(
            t.poseidon_inputs, min_rows=f),
        Table.PoseidonSponge: lambda f: psponge.generate_rows(
            t.poseidon_sponge_ops, min_rows=max(f, psponge.MIN_ROWS),
            device=device),
        Table.Keccak: lambda f: keccak_tab.generate_rows(
            t.keccak_inputs, min_rows=f),
        Table.KeccakSponge: lambda f: ksponge.generate_rows(
            t.keccak_sponge_ops, min_rows=max(f, ksponge.MIN_ROWS)),
        Table.ShaExtend: lambda f: shae.generate_rows(
            t.sha_extend_ops, min_rows=f),
        Table.ShaExtendSponge: lambda f: shaes.generate_rows(
            t.sha_extend_ops, min_rows=f),
        Table.ShaCompress: lambda f: shac.generate_rows(
            t.sha_compress_ops, min_rows=max(f, 128)),
        Table.ShaCompressSponge: lambda f: shacs.generate_rows(
            t.sha_compress_ops, min_rows=f),
        Table.Logic: lambda f: logic.generate_rows(t.logic_ops, min_rows=f),
        Table.Memory: lambda f: mem.generate_rows(t.memory_ops, min_rows=f),
    }
    return [builders[tab](floor_of(tab)) for tab in all_stark.tables]


def segment_witness(seg: Segment, all_stark: AllStark, block_path: str = "",
                    device=None, timer=None, assumptions=()) -> TraceSet:
    """The segment's witness at natural heights (the page sponges on
    `device`), with the sponge ops of the subset's sponge tables, timed as
    "witness".  SYS_VERIFY resolves its claims against `assumptions`."""
    dev = resolve_device(device)
    with step(timer, "witness"):
        return generate_segment_traces(
            seg, block_path=block_path,
            sponge=Table.PoseidonSponge in all_stark.tables,
            keccak=Table.KeccakSponge in all_stark.tables,
            sha=Table.ShaExtendSponge in all_stark.tables,
            assumptions=assumptions, device=dev)


def segment_traces(seg: Segment, all_stark: AllStark, block_path: str = "",
                   height_floors: Optional[Dict[Table, int]] = None,
                   device=None, timer=None) -> List[np.ndarray]:
    """Witness generation + per-table trace building for the subset
    (`trace_set_traces` says how tables are padded)."""
    dev = resolve_device(device)
    ts = segment_witness(seg, all_stark, block_path, dev, timer)
    with step(timer, "trace_build"):
        return trace_set_traces(ts, all_stark, height_floors, dev)


def _device(device, mesh):
    return mesh.device if mesh is not None else resolve_device(device)


def prove_trace_set(trace_set: TraceSet, pv: PublicValues,
                    config: Optional[StarkConfig] = None,
                    all_stark: Optional[AllStark] = None,
                    height_floors: Optional[Dict[Table, int]] = None,
                    device=None, timer=None, debug: bool = False,
                    mesh=None) -> AllProof:
    """Build the subset's traces from a witness and prove them (default:
    SPONGE_SUBSET under standard_fast_config).  With `debug` each table's
    constraints are checked on its rows first (the proof is the same).
    With a tp `mesh` the whole traces stay on the host and each rank
    moves its blocks to its device."""
    dev = _device(device, mesh)
    config = config or StarkConfig.standard_fast_config()
    all_stark = all_stark or make_all_stark()
    with step(timer, "trace_build"):
        rows = trace_set_traces(trace_set, all_stark, height_floors, dev)
    traces = traces_from_rows(rows, "cpu" if mesh is not None else dev)
    return prove_with_traces(all_stark.starks, config, traces,
                             all_stark.ctls, pv, device=dev, timer=timer,
                             debug=debug, mesh=mesh)


def prove_segment(seg: Segment, config: Optional[StarkConfig] = None,
                  all_stark: Optional[AllStark] = None, block_path: str = "",
                  height_floors: Optional[Dict[Table, int]] = None,
                  device=None, timer=None, debug: bool = False,
                  assumptions=(), assumption_usage: Optional[list] = None,
                  mesh=None) -> SegmentReceipt:
    """Re-execute a segment, generate its witness and prove the subset.
    SYS_VERIFY resolves its claims against `assumptions`; the
    (Assumption, AssumptionReceipt) pairs it used are appended to
    `assumption_usage`.  With a `mesh`, every rank of its tp group calls
    this with the same segment and gets the same receipt."""
    dev = _device(device, mesh)
    config = config or StarkConfig.standard_fast_config()
    all_stark = all_stark or make_all_stark()
    ts = segment_witness(seg, all_stark, block_path, dev, timer, assumptions)
    if assumption_usage is not None:
        assumption_usage.extend(ts.assumptions_used)
    pv = public_values_for_segment(seg)
    proof = prove_trace_set(ts, pv, config, all_stark, height_floors, dev,
                            timer, debug, mesh)
    return SegmentReceipt(proof=proof, pre_image_id=seg.pre_image_id,
                          image_id=seg.image_id, userdata=pv.userdata)


def verify_segment(proof: AllProof, config: Optional[StarkConfig] = None,
                   all_stark: Optional[AllStark] = None) -> None:
    """Raise ValueError unless `proof` verifies (host verifier)."""
    config = config or StarkConfig.standard_fast_config()
    all_stark = all_stark or make_all_stark()
    verify_proof(all_stark.starks, proof, all_stark.ctls, config)


def verify_segment_receipt(receipt: SegmentReceipt,
                           config: Optional[StarkConfig] = None,
                           all_stark: Optional[AllStark] = None) -> None:
    verify_segment(receipt.proof, config, all_stark)


def check_receipt_chain(receipts: List[SegmentReceipt]) -> None:
    """Continuation check: each segment's post-state is the next's pre-state
    (the aggregation circuit's roots_after == roots_before link)."""
    for a, b in zip(receipts, receipts[1:]):
        if a.image_id != b.pre_image_id:
            raise ValueError("segment receipts do not chain")
        if a.userdata != b.userdata:
            raise ValueError("userdata mismatch across segments")


def prove_segments(segments: List[Segment],
                   config: Optional[StarkConfig] = None,
                   all_stark: Optional[AllStark] = None, device=None,
                   timer=None, mesh=None) -> List[SegmentReceipt]:
    """Prove every segment and check that the receipts chain.  With a
    (dp, tp) `mesh`, dp group d proves segments d, d + dp, ... on its tp
    group, and the receipts are gathered over dp so that every rank
    returns all of them, in order."""
    if mesh is None or mesh.dp == 1:
        receipts = [prove_segment(s, config, all_stark, device=device,
                                  timer=timer, mesh=mesh) for s in segments]
    else:
        mine = [prove_segment(s, config, all_stark, timer=timer, mesh=mesh)
                for s in segments[mesh.dp_index::mesh.dp]]
        got = mesh.dp_comm.all_gather_object(mine)
        receipts = [got[k % mesh.dp][k // mesh.dp]
                    for k in range(len(segments))]
    check_receipt_chain(receipts)
    return receipts


def prove_elf(elf_path: str, args: List[str] = (),
              inputs: List[bytes] = (), seg_size: int = 65536,
              config: Optional[StarkConfig] = None,
              max_steps: Optional[int] = None, device=None,
              timer=None, mesh=None) -> List[SegmentReceipt]:
    """Full pipeline: load the ELF, execute and split it ("emulate"), prove
    every segment, check the receipts chain.  With a `mesh`, every rank
    emulates and `prove_segments` shares out the segments."""
    dev = _device(device, mesh)
    with step(timer, "emulate"):
        state = load_elf_with_patch(elf_path, list(args), dev)
        for raw in inputs:
            state.add_input_stream_bytes(raw)
        _, segments, _ = split_prog_into_segs(state, None, "", seg_size,
                                              max_steps=max_steps)
    return prove_segments(segments, config, device=dev, timer=timer,
                          mesh=mesh)


def prove_segments_with_assumptions(
        segments: List[Segment], assumptions=(),
        config: Optional[StarkConfig] = None,
        all_stark: Optional[AllStark] = None, debug: bool = False,
        block_path: str = "", device=None, timer=None) -> Receipt:
    """Prove a segment chain under an assumption environment, producing a
    `Receipt` (Segments, or Composite when SYS_VERIFY used an assumption):
    zkMIPS's `prove_with_assumptions` and sha2-composition example
    (prover.rs:58-127, fixed_recursive_verifier.rs:835-914)."""
    dev = resolve_device(device)
    usage: list = []
    seg_receipts = [
        prove_segment(s, config, all_stark, block_path, device=dev,
                      timer=timer, debug=debug, assumptions=assumptions,
                      assumption_usage=usage)
        for s in segments]
    check_receipt_chain(seg_receipts)
    inner = InnerReceipt(
        segments=seg_receipts,
        claim=ReceiptClaim(elf_id=seg_receipts[0].pre_image_id,
                           commit=seg_receipts[0].userdata))
    if usage:
        return Receipt.composite(CompositeReceipt(
            program_receipt=inner, assumptions_used=usage))
    return Receipt.segments(inner)
