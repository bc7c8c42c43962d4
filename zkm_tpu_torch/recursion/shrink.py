"""Stage R2: the shrink STARK — prove "the verifier DAG ran and accepted".

Copy of zkm_tpu/recursion/shrink.py (analog of zkMIPS
prover/src/recursive_verifier.rs `recursive_stark_circuit` +
fixed_recursive_verifier.rs:377-611, per-table shrink and the root
circuit).  It proves the recorded verifier DAG (recursion/dag.py) with the
SAME multi-table STARK engine, over four uniform tables (docs/recursion.md
stage R2):

  * VerifierVmStark   — one row per scalar DAG op (const/pub/add/sub/mul/
                        hint/assert); values bound by a wire memory.  Row 0
                        is the claim row: 48 public-input boundary
                        constraints bind (roots_before, roots_after,
                        userdata) and 48 CTL read channels bind them to the
                        DAG's claim wires.
  * WireMemStark      — write-once wire memory, sorted by address.  The CTL
                        multiset (every access appears exactly once on both
                        sides, and the program forces exactly one write per
                        wire) makes plain sortedness constraints sufficient:
                        address increments are {0,1}, each block starts with
                        its write, values are constant within a block — no
                        range checks needed.
  * PoseidonCallStark — one row per Poseidon macro node: 12 wire reads,
                        12 wire writes, and input/output CTLs into the
                        existing Poseidon table (timestamp-bound, like the
                        sponge tables).
  * VerifierProgramStark — the program: op flags, wire indices, constants.
                        Its trace is deterministic, so its trace cap IS the
                        verifying key (the analog of plonky2's
                        constants_sigmas_cap in VerifierCircuitData): the
                        outer verifier checks cap equality against the
                        known circuit digest.

The shrink proof's PublicValues equal the inner proof's claim, so receipt
chaining and aggregation treat shrunk receipts transparently.

The tables' rows are built in numpy on the host, as (C, N) u64 arrays,
and go to the device through `convert.traces_from_rows`.  The DAG replay
(`dag.evaluate`) is host Python.  The program commitment (the verifying
key) and the proofs run on `device` (the card unless device='cpu').
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..commit.polynomial_batch import PolynomialBatch
from ..convert import from_u64, traces_from_rows
from ..device import resolve_device
from ..field import goldilocks as gl
from ..stark.columns import Column, Filter
from ..stark.config import StarkConfig
from ..stark.cross_table_lookup import CrossTableLookup, TableWithColumns
from ..stark.proof import AllProof, PublicValues, flatten_proof
from ..stark.prover import prove_with_traces
from ..stark.stark import Stark
from ..stark.verifier import verify_proof
from ..tables import poseidon as poseidon_mod
from ..utils.timing import step
from .dag import Dag, evaluate
from .verifier_dag import VerifierDag, record_chain, record_verifier

P = gl.P
NUM_CLAIM = 48   # 8 roots_before + 8 roots_after + 32 userdata bytes

# shrink-system table indices
VM, WIREMEM, POSECALL, POSEIDON, PROGRAM = range(5)


# ---------------------------------------------------------------------------
# VerifierVmStark
# ---------------------------------------------------------------------------

F_CONST, F_PUB, F_ADD, F_SUB, F_MUL, F_HINT, F_ASSERT = range(7)
NUM_OP_FLAGS = 7
IN0, IN1, OUT, CVAL = 7, 8, 9, 10
V0, V1, VOUT = 11, 12, 13
F_CLAIM = 14
CLAIM_START = 15
VM_COLUMNS = CLAIM_START + NUM_CLAIM

_WRITE_FLAGS = (F_CONST, F_PUB, F_ADD, F_SUB, F_MUL, F_HINT)
_READ0_FLAGS = (F_ADD, F_SUB, F_MUL, F_ASSERT)
_READ1_FLAGS = (F_ADD, F_SUB, F_MUL)


class VerifierVmStark(Stark):
    num_columns = VM_COLUMNS
    num_public_inputs = NUM_CLAIM

    def public_inputs(self, roots_before, roots_after, userdata):
        return list(roots_before) + list(roots_after) + list(userdata)

    def eval_generic(self, a, lv, nv, consumer, publics):
        # booleanity: op flags + claim flag
        for c in list(range(NUM_OP_FLAGS)) + [F_CLAIM]:
            f = lv[c]
            consumer.constraint(a.mul(f, a.sub(f, a.one)))
        opsum = lv[F_CONST]
        for c in range(1, NUM_OP_FLAGS):
            opsum = a.add(opsum, lv[c])
        consumer.constraint(a.mul(opsum, a.sub(opsum, a.one)))
        # the claim row is not an op row
        consumer.constraint(a.mul(lv[F_CLAIM], opsum))

        v0, v1, vout = lv[V0], lv[V1], lv[VOUT]
        consumer.constraint(a.mul(lv[F_ADD], a.sub(vout, a.add(v0, v1))))
        consumer.constraint(a.mul(lv[F_SUB], a.sub(vout, a.sub(v0, v1))))
        consumer.constraint(a.mul(lv[F_MUL], a.sub(vout, a.mul(v0, v1))))
        consumer.constraint(a.mul(lv[F_CONST], a.sub(vout, lv[CVAL])))
        consumer.constraint(a.mul(lv[F_ASSERT], v0))

        # F_CLAIM is exactly the first row
        consumer.constraint_first_row(a.sub(lv[F_CLAIM], a.one))
        consumer.constraint_transition(nv[F_CLAIM])

        # claim boundary: row 0 claim columns == public inputs
        for i in range(NUM_CLAIM):
            consumer.constraint_first_row(
                a.sub(lv[CLAIM_START + i], a.from_base(publics[i])))


def vm_op_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(range(NUM_OP_FLAGS)))


def vm_program_cols() -> List[Column]:
    return Column.singles(list(range(NUM_OP_FLAGS)) + [IN0, IN1, OUT, CVAL])


def vm_mem_channels() -> List[Tuple[Tuple[Column, ...], Filter]]:
    """(addr, value, is_write) channels: two reads + one write."""
    read0 = ((Column.single(IN0), Column.single(V0), Column.zero()),
             Filter.new_simple(Column.sum_cols(_READ0_FLAGS)))
    read1 = ((Column.single(IN1), Column.single(V1), Column.zero()),
             Filter.new_simple(Column.sum_cols(_READ1_FLAGS)))
    write = ((Column.single(OUT), Column.single(VOUT), Column.one()),
             Filter.new_simple(Column.sum_cols(_WRITE_FLAGS)))
    return [read0, read1, write]


def vm_claim_channels(claim_wires: Sequence[int]) -> List[
        Tuple[Tuple[Column, ...], Filter]]:
    """48 read channels on the claim row: wire ids are circuit constants."""
    filt = Filter.new_simple(Column.single(F_CLAIM))
    return [((Column.constant_col(int(w)),
              Column.single(CLAIM_START + i), Column.zero()), filt)
            for i, w in enumerate(claim_wires)]


# ---------------------------------------------------------------------------
# WireMemStark
# ---------------------------------------------------------------------------

M_ADDR, M_VAL, M_IS_WRITE, M_IS_REAL = range(4)
WIREMEM_COLUMNS = 4


class WireMemStark(Stark):
    num_columns = WIREMEM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        is_w, is_r = lv[M_IS_WRITE], lv[M_IS_REAL]
        consumer.constraint(a.mul(is_w, a.sub(is_w, a.one)))
        consumer.constraint(a.mul(is_r, a.sub(is_r, a.one)))
        # padding rows are reads (inert) and form a suffix
        consumer.constraint(a.mul(a.sub(a.one, is_r), is_w))
        consumer.constraint_transition(
            a.mul(a.sub(a.one, is_r), nv[M_IS_REAL]))
        # first row is a real write at address 0 (circuits are nonempty)
        consumer.constraint_first_row(a.sub(is_r, a.one))
        consumer.constraint_first_row(a.sub(is_w, a.one))
        consumer.constraint_first_row(lv[M_ADDR])
        # transitions on the real prefix
        g = nv[M_IS_REAL]
        d = a.sub(nv[M_ADDR], lv[M_ADDR])
        consumer.constraint_transition(a.mul(g, a.mul(d, a.sub(d, a.one))))
        consumer.constraint_transition(
            a.mul(g, a.mul(d, a.sub(a.one, nv[M_IS_WRITE]))))
        same = a.sub(a.one, d)
        consumer.constraint_transition(
            a.mul(g, a.mul(same, a.sub(nv[M_VAL], lv[M_VAL]))))
        consumer.constraint_transition(
            a.mul(g, a.mul(same, nv[M_IS_WRITE])))


def wiremem_looked_cols() -> List[Column]:
    return Column.singles([M_ADDR, M_VAL, M_IS_WRITE])


def wiremem_looked_filter() -> Filter:
    return Filter.new_simple(Column.single(M_IS_REAL))


# ---------------------------------------------------------------------------
# PoseidonCallStark
# ---------------------------------------------------------------------------

PC_IN_W = 0            # 12 input wire ids
PC_OUT_W = 12          # 12 output wire ids
PC_IN_V = 24           # 12 input values
PC_OUT_V = 36          # 12 output values
PC_TS = 48
PC_IS_REAL = 49
POSECALL_COLUMNS = 50


class PoseidonCallStark(Stark):
    num_columns = POSECALL_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        is_r = lv[PC_IS_REAL]
        consumer.constraint(a.mul(is_r, a.sub(is_r, a.one)))
        consumer.constraint_transition(
            a.mul(a.sub(a.one, is_r), nv[PC_IS_REAL]))
        # distinct timestamps on the real prefix: ts_0 = 1, ts' = ts + 1
        consumer.constraint_first_row(a.mul(is_r, a.sub(lv[PC_TS], a.one)))
        consumer.constraint_transition(a.mul(
            nv[PC_IS_REAL], a.sub(nv[PC_TS], a.add(lv[PC_TS], a.one))))


def posecall_mem_channels() -> List[Tuple[Tuple[Column, ...], Filter]]:
    filt = Filter.new_simple(Column.single(PC_IS_REAL))
    chans = []
    for j in range(12):
        chans.append(((Column.single(PC_IN_W + j),
                       Column.single(PC_IN_V + j), Column.zero()), filt))
    for j in range(12):
        chans.append(((Column.single(PC_OUT_W + j),
                       Column.single(PC_OUT_V + j), Column.one()), filt))
    return chans


def posecall_widx_cols() -> List[Column]:
    return Column.singles(list(range(PC_IN_W, PC_IN_W + 12)) +
                          list(range(PC_OUT_W, PC_OUT_W + 12)))


def posecall_inputs_cols() -> List[Column]:
    return Column.singles(list(range(PC_IN_V, PC_IN_V + 12)) + [PC_TS])


def posecall_outputs_cols() -> List[Column]:
    return Column.singles(list(range(PC_OUT_V, PC_OUT_V + 12)) + [PC_TS])


def posecall_filter() -> Filter:
    return Filter.new_simple(Column.single(PC_IS_REAL))


# ---------------------------------------------------------------------------
# VerifierProgramStark — content is vouched by the verifying-key cap check;
# in-table constraints only keep the flag columns boolean.
# ---------------------------------------------------------------------------

PR_POSE = 7                    # op flags reuse columns 0..6
PR_IN0, PR_IN1, PR_OUT, PR_CVAL = 8, 9, 10, 11
PR_WIDX = 12                   # 24 poseidon wire ids
PROGRAM_COLUMNS = 36


class VerifierProgramStark(Stark):
    num_columns = PROGRAM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        total = None
        for c in range(NUM_OP_FLAGS + 1):        # op flags + pose flag
            f = lv[c]
            consumer.constraint(a.mul(f, a.sub(f, a.one)))
            total = f if total is None else a.add(total, f)
        consumer.constraint(a.mul(total, a.sub(total, a.one)))


def program_op_cols() -> List[Column]:
    return Column.singles(list(range(NUM_OP_FLAGS)) +
                          [PR_IN0, PR_IN1, PR_OUT, PR_CVAL])


def program_op_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(range(NUM_OP_FLAGS)))


def program_pose_cols() -> List[Column]:
    return Column.singles(range(PR_WIDX, PR_WIDX + 24))


def program_pose_filter() -> Filter:
    return Filter.new_simple(Column.single(PR_POSE))


# ---------------------------------------------------------------------------
# CTL topology
# ---------------------------------------------------------------------------

def make_shrink_ctls(claim_wires: Sequence[int]) -> List[CrossTableLookup]:
    # 1. VM op rows <-> program non-pose rows
    ctl_program_ops = CrossTableLookup(
        (TableWithColumns(VM, tuple(vm_program_cols()), vm_op_filter()),),
        TableWithColumns(PROGRAM, tuple(program_op_cols()),
                         program_op_filter()))
    # 2. Poseidon call rows <-> program pose rows
    ctl_program_pose = CrossTableLookup(
        (TableWithColumns(POSECALL, tuple(posecall_widx_cols()),
                          posecall_filter()),),
        TableWithColumns(PROGRAM, tuple(program_pose_cols()),
                         program_pose_filter()))
    # 3. all wire accesses <-> wire memory rows
    looking = []
    for cols, filt in (vm_mem_channels() + vm_claim_channels(claim_wires)):
        looking.append(TableWithColumns(VM, cols, filt))
    for cols, filt in posecall_mem_channels():
        looking.append(TableWithColumns(POSECALL, cols, filt))
    ctl_wiremem = CrossTableLookup(
        tuple(looking),
        TableWithColumns(WIREMEM, tuple(wiremem_looked_cols()),
                         wiremem_looked_filter()))
    # 4./5. poseidon call inputs/outputs <-> Poseidon table rows
    ctl_pose_inputs = CrossTableLookup(
        (TableWithColumns(POSECALL, tuple(posecall_inputs_cols()),
                          posecall_filter()),),
        TableWithColumns(POSEIDON, tuple(poseidon_mod.ctl_data_inputs()),
                         poseidon_mod.ctl_filter()))
    ctl_pose_outputs = CrossTableLookup(
        (TableWithColumns(POSECALL, tuple(posecall_outputs_cols()),
                          posecall_filter()),),
        TableWithColumns(POSEIDON, tuple(poseidon_mod.ctl_data_outputs()),
                         poseidon_mod.ctl_filter()))
    return [ctl_program_ops, ctl_program_pose, ctl_wiremem,
            ctl_pose_inputs, ctl_pose_outputs]


# ---------------------------------------------------------------------------
# Program + witness generation from a recorded DAG
# ---------------------------------------------------------------------------

def _pad_rows(rows: np.ndarray, min_rows: int = 64) -> np.ndarray:
    n = max(len(rows), min_rows, 2)
    n = 1 << (n - 1).bit_length()
    if len(rows) < n:
        pad = np.zeros((n - len(rows), rows.shape[1]), dtype=np.uint64)
        rows = np.concatenate([rows, pad], axis=0)
    return rows


@dataclass
class _Program:
    """Flat op stream: one entry per VM row (claim row excluded) and one per
    poseidon call.  Also caches the access pattern for witness generation."""
    op_rows: np.ndarray        # (n_ops, 12): 7 flags + in0,in1,out,cval + 0
    pose_rows: np.ndarray      # (n_calls, 24) wire ids
    claim_wires: np.ndarray    # (48,)


def build_program(dag: Dag, claim_wires=None) -> _Program:
    ops = []
    pose = []
    for e in dag.prog:
        tag = e[0]
        if tag == 'c':
            ops.append((F_CONST, 0, 0, e[1], e[2]))
        elif tag == 'i':
            ops.append((F_PUB, 0, 0, e[1], 0))
        elif tag == '+':
            ops.append((F_ADD, e[2], e[3], e[1], 0))
        elif tag == '-':
            ops.append((F_SUB, e[2], e[3], e[1], 0))
        elif tag == '*':
            ops.append((F_MUL, e[2], e[3], e[1], 0))
        elif tag == 'h':
            for w in e[1]:
                ops.append((F_HINT, 0, 0, w, 0))
        else:  # 'p'
            pose.append(tuple(e[2]) + tuple(e[1]))
    for w, _label in dag.asserts:
        ops.append((F_ASSERT, w, 0, 0, 0))

    op_rows = np.zeros((len(ops), NUM_OP_FLAGS + 5), dtype=np.uint64)
    for r, (flag, i0, i1, out, cval) in enumerate(ops):
        op_rows[r, flag] = 1
        op_rows[r, NUM_OP_FLAGS + 0] = i0
        op_rows[r, NUM_OP_FLAGS + 1] = i1
        op_rows[r, NUM_OP_FLAGS + 2] = out
        op_rows[r, NUM_OP_FLAGS + 3] = cval
    pose_rows = np.asarray(pose, dtype=np.uint64).reshape(len(pose), 24)
    if claim_wires is None:
        claim_wires = dag.pub[:NUM_CLAIM]
    return _Program(op_rows=op_rows, pose_rows=pose_rows,
                    claim_wires=np.asarray(claim_wires, dtype=np.uint64))


def program_trace(prog: _Program) -> np.ndarray:
    """Deterministic program table rows, (C, N) u64 (their cap is the
    verifying key)."""
    n_ops, n_pose = len(prog.op_rows), len(prog.pose_rows)
    rows = np.zeros((n_ops + n_pose, PROGRAM_COLUMNS), dtype=np.uint64)
    rows[:n_ops, :NUM_OP_FLAGS] = prog.op_rows[:, :NUM_OP_FLAGS]
    rows[:n_ops, PR_IN0:PR_CVAL + 1] = prog.op_rows[:, NUM_OP_FLAGS:
                                                    NUM_OP_FLAGS + 4]
    rows[n_ops:, PR_POSE] = 1
    rows[n_ops:, PR_WIDX:PR_WIDX + 24] = prog.pose_rows
    return _pad_rows(rows).T.copy()


def generate_shrink_traces(dag: Dag, prog: _Program,
                           pub_values: Sequence[int],
                           timer=None) -> List[np.ndarray]:
    """Evaluate the DAG ("dag_evaluate") and build all five tables' (C, N)
    u64 rows ("shrink_traces")."""
    with step(timer, "dag_evaluate"):
        vals = np.asarray(evaluate(dag, pub_values), dtype=np.uint64)
    with step(timer, "shrink_traces"):
        return _shrink_rows(prog, vals)


def _shrink_rows(prog: _Program, vals: np.ndarray) -> List[np.ndarray]:

    op = prog.op_rows
    n_ops = len(op)
    i0 = op[:, NUM_OP_FLAGS + 0].astype(np.int64)
    i1 = op[:, NUM_OP_FLAGS + 1].astype(np.int64)
    out = op[:, NUM_OP_FLAGS + 2].astype(np.int64)
    has_r0 = (op[:, _READ0_FLAGS].sum(axis=1) > 0)   # includes assert reads
    has_r1 = (op[:, _READ1_FLAGS].sum(axis=1) > 0)
    has_w = (op[:, _WRITE_FLAGS].sum(axis=1) > 0)

    # -- VM trace (row 0 = claim row; claim values come from the claim
    # WIRES — for shrink DAGs those are pubs[:48], for aggregation DAGs the
    # combined (lhs.roots_before, rhs.roots_after, userdata)) --------------
    vm = np.zeros((1 + n_ops, VM_COLUMNS), dtype=np.uint64)
    vm[0, F_CLAIM] = 1
    vm[0, CLAIM_START:CLAIM_START + NUM_CLAIM] = \
        vals[prog.claim_wires.astype(np.int64)]
    vm[1:, :NUM_OP_FLAGS] = op[:, :NUM_OP_FLAGS]
    vm[1:, IN0:CVAL + 1] = op[:, NUM_OP_FLAGS:NUM_OP_FLAGS + 4]
    vm[1:, V0] = np.where(has_r0, vals[i0], 0)
    vm[1:, V1] = np.where(has_r1, vals[i1], 0)
    vm[1:, VOUT] = np.where(has_w, vals[out], 0)

    # -- wire memory -----------------------------------------------------------
    addrs, values, writes = [], [], []
    # writes: every op output, every poseidon output
    addrs.append(out[has_w])
    values.append(vals[out[has_w]])
    writes.append(np.ones(int(has_w.sum()), dtype=np.uint64))
    # reads from VM rows
    r0_addr = i0[has_r0]
    addrs.append(r0_addr)
    values.append(vals[r0_addr])
    writes.append(np.zeros(len(r0_addr), dtype=np.uint64))
    addrs.append(i1[has_r1])
    values.append(vals[i1[has_r1]])
    writes.append(np.zeros(int(has_r1.sum()), dtype=np.uint64))
    # claim reads
    cw = prog.claim_wires.astype(np.int64)
    addrs.append(cw)
    values.append(vals[cw])
    writes.append(np.zeros(NUM_CLAIM, dtype=np.uint64))
    # poseidon call accesses
    if len(prog.pose_rows):
        pin = prog.pose_rows[:, :12].astype(np.int64).ravel()
        pout = prog.pose_rows[:, 12:].astype(np.int64).ravel()
        addrs += [pin, pout]
        values += [vals[pin], vals[pout]]
        writes += [np.zeros(len(pin), dtype=np.uint64),
                   np.ones(len(pout), dtype=np.uint64)]

    addr = np.concatenate(addrs).astype(np.uint64)
    val = np.concatenate(values)
    is_write = np.concatenate(writes)
    order = np.lexsort((1 - is_write, addr))   # by addr, write first
    wm = np.zeros((len(addr), WIREMEM_COLUMNS), dtype=np.uint64)
    wm[:, M_ADDR] = addr[order]
    wm[:, M_VAL] = val[order]
    wm[:, M_IS_WRITE] = is_write[order]
    wm[:, M_IS_REAL] = 1

    # -- poseidon calls + poseidon rows ---------------------------------------
    n_calls = len(prog.pose_rows)
    pc = np.zeros((max(n_calls, 1), POSECALL_COLUMNS), dtype=np.uint64)
    perms = []
    for r in range(n_calls):
        ins = prog.pose_rows[r, :12].astype(np.int64)
        outs = prog.pose_rows[r, 12:].astype(np.int64)
        pc[r, PC_IN_W:PC_IN_W + 12] = ins
        pc[r, PC_OUT_W:PC_OUT_W + 12] = outs
        pc[r, PC_IN_V:PC_IN_V + 12] = vals[ins]
        pc[r, PC_OUT_V:PC_OUT_V + 12] = vals[outs]
        pc[r, PC_TS] = r + 1
        pc[r, PC_IS_REAL] = 1
        perms.append(([int(v) for v in vals[ins]], r + 1))

    return [
        _pad_rows(vm).T.copy(),
        _pad_rows(wm).T.copy(),
        _pad_rows(pc).T.copy(),
        poseidon_mod.generate_rows(perms),
        program_trace(prog),
    ]


# ---------------------------------------------------------------------------
# Circuit assembly + prove/verify entry points
# ---------------------------------------------------------------------------

@dataclass
class ShrinkCircuit:
    """Fixed shrink circuit for inner proofs of one shape.

    `program_cap` is the verifying key: the deterministic program table's
    trace commitment cap (checked by verify_shrink / pinned in outer DAGs)."""
    vdag: VerifierDag
    prog: _Program
    starks: tuple
    ctls: list
    config: StarkConfig
    program_cap: np.ndarray


def make_shrink_starks() -> tuple:
    return (VerifierVmStark(), WireMemStark(), PoseidonCallStark(),
            poseidon_mod.PoseidonStark(), VerifierProgramStark())


def build_shrink_circuit(inner_starks: Sequence, inner_ctls,
                         inner_config: StarkConfig, template: AllProof,
                         config: Optional[StarkConfig] = None,
                         cap_pins=None, device=None,
                         timer=None) -> ShrinkCircuit:
    """Record the verifier of (inner_starks, inner_ctls, inner_config) for
    proofs shaped like `template` ("record_dag"), and fix the shrink
    tables around it."""
    config = config or inner_config
    with step(timer, "record_dag"):
        vdag = record_verifier(inner_starks, inner_ctls, inner_config,
                               template, cap_pins=cap_pins)
    return _assemble_circuit(vdag, config, device, timer)


def build_aggregation_circuit(child_starks: Sequence, child_ctls,
                              child_config: StarkConfig,
                              templates: Sequence[AllProof],
                              child_program_caps: Sequence[np.ndarray],
                              config: Optional[StarkConfig] = None,
                              device=None, timer=None) -> ShrinkCircuit:
    """Stage R3: the binary aggregation node (reference analog
    fixed_recursive_verifier.rs:613-695 `prove_aggregation`).

    Records ONE DAG verifying every child proof (each a 5-table
    shrink-system proof, its PROGRAM cap pinned to the matching
    `child_program_caps[i]` — the verifying-key check is in-DAG, so a
    forged child circuit fails witness replay), plus the continuation
    links `lhs.roots_after == rhs.roots_before` and equal userdata
    (`fixed_recursive_verifier.rs:636-641`).  The result is proved by the
    SAME 5-table system, so aggregation nodes compose into trees: level
    k+1 pins level k's program caps.  The combined claim is
    (first.roots_before, last.roots_after, userdata)."""
    config = config or child_config
    with step(timer, "record_dag"):
        vdag = record_chain(
            child_starks, child_ctls, child_config, templates,
            [{PROGRAM: cap} for cap in child_program_caps])
    return _assemble_circuit(vdag, config, device, timer)


def _assemble_circuit(vdag: VerifierDag, config: StarkConfig, device=None,
                      timer=None) -> ShrinkCircuit:
    """The program table and its commitment's cap, the verifying key
    ("program_commit")."""
    dev = resolve_device(device)
    prog = build_program(vdag.dag, vdag.claim_wires)
    starks = make_shrink_starks()
    ctls = make_shrink_ctls([int(w) for w in prog.claim_wires])
    with step(timer, "program_commit"):
        pcommit = PolynomialBatch.from_values(
            from_u64(program_trace(prog), dev), config.fri_config.rate_bits,
            config.fri_config.cap_height, device=dev)
        program_cap = pcommit.cap_u64()
    return ShrinkCircuit(vdag=vdag, prog=prog, starks=starks, ctls=ctls,
                         config=config, program_cap=np.asarray(program_cap))


def _prove_dag(circuit: ShrinkCircuit, pubs: List[int], pv: PublicValues,
               debug: bool, device, timer) -> AllProof:
    dev = resolve_device(device)
    rows = generate_shrink_traces(circuit.vdag.dag, circuit.prog, pubs,
                                  timer)
    return prove_with_traces(circuit.starks, circuit.config,
                             traces_from_rows(rows, dev), circuit.ctls, pv,
                             device=dev, timer=timer, debug=debug)


def prove_shrink(circuit: ShrinkCircuit, inner_proof: AllProof,
                 debug: bool = False, device=None, timer=None) -> AllProof:
    """Shrink `inner_proof` (same shape as the circuit's template) into a
    fixed-shape 5-table proof with the same PublicValues claim.  Runs on
    the card unless device='cpu'; `timer` gets "dag_evaluate",
    "shrink_traces" and the prover's steps."""
    return _prove_dag(circuit, flatten_proof(inner_proof),
                      inner_proof.public_values, debug, device, timer)


def prove_aggregation(circuit: ShrinkCircuit,
                      children: Sequence[AllProof],
                      debug: bool = False, device=None,
                      timer=None) -> AllProof:
    """Aggregate a chain of child proofs (shapes = the circuit's templates)
    into one fixed-shape proof claiming (first.roots_before,
    last.roots_after, userdata).  Continuation violations and wrong child
    verifying keys surface as ReplayFailure during witness generation,
    before anything is proved."""
    pubs: List[int] = []
    for child in children:
        pubs.extend(flatten_proof(child))
    merged = PublicValues(
        roots_before=children[0].public_values.roots_before,
        roots_after=children[-1].public_values.roots_after,
        userdata=children[0].public_values.userdata)
    return _prove_dag(circuit, pubs, merged, debug, device, timer)


def verify_shrink(circuit: ShrinkCircuit, proof: AllProof):
    """Verify a shrink proof: STARK verification + the verifying-key check
    (program table cap == the circuit's deterministic program commitment)."""
    got = np.asarray(proof.stark_proofs[PROGRAM].proof.trace_cap)
    if got.shape != circuit.program_cap.shape or \
            not (got == circuit.program_cap).all():
        raise ValueError("program commitment does not match verifying key")
    verify_proof(circuit.starks, proof, circuit.ctls, circuit.config)
