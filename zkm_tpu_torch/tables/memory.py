"""Memory table: consistency of all memory operations.

Copy of zkm_tpu/tables/memory.py (zkMIPS prover/src/memory/): 13
columns, rows sorted by (context, segment, virt, timestamp);
read-after-write equality; ordering
enforced by first-change flags + a logUp range check of the delta against a
counter column; `fill_gaps` inserts dummy reads so deltas stay below the
trace height; R0 (ctx 0, RegisterFile, virt 0) writes are value-coerced to 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..stark.columns import Column, Filter
from ..stark.lookup import Lookup
from ..stark.stark import Stark

FILTER = 0
TIMESTAMP = 1
IS_READ = 2
ADDR_CONTEXT = 3
ADDR_SEGMENT = 4
ADDR_VIRTUAL = 5
VALUE = 6
CONTEXT_FIRST_CHANGE = 7
SEGMENT_FIRST_CHANGE = 8
VIRTUAL_FIRST_CHANGE = 9
RANGE_CHECK = 10
COUNTER = 11
FREQUENCIES = 12
NUM_COLUMNS = 13

# memory segments (reference memory/segments.rs)
SEG_CODE = 0
SEG_KERNEL_GENERAL = 1
SEG_KERNEL_GENERAL2 = 2
SEG_SHIFT_TABLE = 3
SEG_REGISTER_FILE = 4

NUM_CHANNELS = 10  # timestamp = clock * NUM_CHANNELS (witness/memory.rs:86)


@dataclass(frozen=True)
class MemoryOp:
    filter: bool
    timestamp: int
    is_read: bool
    context: int
    segment: int
    virt: int
    value: int

    def sorting_key(self):
        return (self.context, self.segment, self.virt, self.timestamp)


def _fill_gaps(ops: List[MemoryOp]) -> List[MemoryOp]:
    """Insert dummy reads so every sorted-row delta fits the range check
    (memory_stark.rs:175-204).

    Deviation: the reference fixes max_rc from the pre-fill op count, so a
    small segment whose image spans the 0x80000000 page-hash region inserts
    ~gap/max_rc dummies (a 27x table blowup at 10k ops).  We instead find
    the smallest power-of-two height whose own bound absorbs the dummies it
    induces — identical constraints (rc < height), minimal height."""
    n_bits = max((len(ops) - 1).bit_length(), 1)
    while True:
        max_rc = (1 << n_bits) - 1
        out = list(ops)
        for curr, nxt in zip(ops, ops[1:]):
            if curr.context != nxt.context or curr.segment != nxt.segment:
                continue
            if curr.virt != nxt.virt:
                while nxt.virt - curr.virt - 1 > max_rc:
                    curr = MemoryOp(False, 0, True, curr.context,
                                    curr.segment, curr.virt + max_rc + 1, 0)
                    out.append(curr)
            else:
                while nxt.timestamp - curr.timestamp > max_rc:
                    curr = MemoryOp(False, curr.timestamp + max_rc, True,
                                    curr.context, curr.segment, curr.virt,
                                    curr.value)
                    out.append(curr)
        if len(out) <= (1 << n_bits):
            # the table height MUST be the 2^n_bits the fill converged on:
            # a sparser fill (larger max_rc) can leave fewer ops than the
            # next power of two below 2^n_bits, and rc deltas sized for
            # 2^n_bits would overflow that smaller height's range check
            return out, n_bits
        n_bits += 1


def _coerce_r0(op: MemoryOp) -> MemoryOp:
    """R0 writes read back as 0; coerce *before* fill_gaps so dummy reads
    inherit the coerced value (the reference coerces at row build time,
    memory_stark.rs:64-73 — done earlier here so gap-filling dummies stay
    consistent with the write row)."""
    if (not op.is_read and op.context == 0
            and op.segment == SEG_REGISTER_FILE and op.virt == 0
            and op.value != 0):
        return MemoryOp(op.filter, op.timestamp, op.is_read, op.context,
                        op.segment, op.virt, 0)
    return op


def generate_rows(ops: List[MemoryOp], min_rows: int = 64) -> np.ndarray:
    """Raw (NUM_COLUMNS, N) uint64 trace values."""
    assert ops, "no memory ops"
    ops = [_coerce_r0(op) for op in ops]
    ops = sorted(ops, key=MemoryOp.sorting_key)
    ops, fill_bits = _fill_gaps(ops)
    ops.sort(key=MemoryOp.sorting_key)
    # padding: repeat last op as filtered-out read
    last = ops[-1]
    pad_op = MemoryOp(False, last.timestamp, True, last.context, last.segment,
                      last.virt, last.value)
    n = max(len(ops), 1 << fill_bits, min_rows, 2)
    n = 1 << (n - 1).bit_length()
    ops = ops + [pad_op] * (n - len(ops))

    # column-major vectorized row build (the reference builds rows one at
    # a time; at 2^20 ops the Python loop dominated witness time)
    rows = np.zeros((n, NUM_COLUMNS), dtype=np.uint64)
    rows[:, FILTER] = np.fromiter((op.filter for op in ops), bool, n)
    rows[:, TIMESTAMP] = np.fromiter(
        (op.timestamp for op in ops), np.uint64, n)
    rows[:, IS_READ] = np.fromiter((op.is_read for op in ops), bool, n)
    rows[:, ADDR_CONTEXT] = np.fromiter(
        (op.context for op in ops), np.uint64, n)
    rows[:, ADDR_SEGMENT] = np.fromiter(
        (op.segment for op in ops), np.uint64, n)
    rows[:, ADDR_VIRTUAL] = np.fromiter(
        (op.virt for op in ops), np.uint64, n)
    rows[:, VALUE] = np.fromiter((op.value for op in ops), np.uint64, n)

    # first-change flags + range check, vectorized over row pairs
    ctx, seg = rows[:, ADDR_CONTEXT], rows[:, ADDR_SEGMENT]
    virt, ts = rows[:, ADDR_VIRTUAL], rows[:, TIMESTAMP]
    ctx_ch = ctx[:-1] != ctx[1:]
    seg_ch = (seg[:-1] != seg[1:]) & ~ctx_ch
    virt_ch = (virt[:-1] != virt[1:]) & ~ctx_ch & ~seg_ch
    rows[:-1, CONTEXT_FIRST_CHANGE] = ctx_ch
    rows[:-1, SEGMENT_FIRST_CHANGE] = seg_ch
    rows[:-1, VIRTUAL_FIRST_CHANGE] = virt_ch
    rc = np.where(
        ctx_ch, ctx[1:] - ctx[:-1] - 1,
        np.where(seg_ch, seg[1:] - seg[:-1] - 1,
                 np.where(virt_ch, virt[1:] - virt[:-1] - 1,
                          ts[1:] - ts[:-1])))
    assert int(rc.max(initial=0)) < n, "range check too large; fill_gaps bug?"
    rows[:-1, RANGE_CHECK] = rc
    rows[:, COUNTER] = np.arange(n, dtype=np.uint64)
    freq = np.bincount(rows[:, RANGE_CHECK].astype(np.int64), minlength=n)
    rows[:, FREQUENCIES] = freq
    return rows.T.copy()


def ctl_data() -> List[Column]:
    cols = Column.singles([IS_READ, ADDR_CONTEXT, ADDR_SEGMENT, ADDR_VIRTUAL,
                           VALUE, TIMESTAMP])
    return cols


def ctl_filter() -> Filter:
    return Filter.new_simple(Column.single(FILTER))


class MemoryStark(Stark):
    num_columns = NUM_COLUMNS

    def lookups(self):
        return [Lookup(columns=(Column.single(RANGE_CHECK),),
                       table_column=Column.single(COUNTER),
                       frequencies_column=Column.single(FREQUENCIES),
                       filter_columns=(None,))]

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one
        timestamp = lv[TIMESTAMP]
        addr_c, addr_s, addr_v = lv[ADDR_CONTEXT], lv[ADDR_SEGMENT], \
            lv[ADDR_VIRTUAL]
        value = lv[VALUE]
        n_timestamp = nv[TIMESTAMP]
        n_is_read = nv[IS_READ]
        n_addr_c, n_addr_s, n_addr_v = nv[ADDR_CONTEXT], nv[ADDR_SEGMENT], \
            nv[ADDR_VIRTUAL]
        n_value = nv[VALUE]

        filt = lv[FILTER]
        consumer.constraint(a.mul(filt, a.sub(filt, one)))
        is_read = lv[IS_READ]
        consumer.constraint(a.mul(is_read, a.sub(is_read, one)))

        # Dummy (filter=0) rows must be reads, except the R0 write
        # (ctx 0, SEG_REGISTER_FILE, virt 0, value 0).  Stronger than the
        # reference, whose dummy=>read check is commented out
        # (memory_stark.rs:287-295) because R0 writes also clear the filter:
        # here dummy writes are pinned to exactly the harmless R0 shape.
        dummy_write = a.mul(a.sub(one, filt), a.sub(one, is_read))
        consumer.constraint(a.mul(dummy_write, lv[ADDR_CONTEXT]))
        consumer.constraint(a.mul(dummy_write, a.sub(
            lv[ADDR_SEGMENT], a.constant(SEG_REGISTER_FILE))))
        consumer.constraint(a.mul(dummy_write, lv[ADDR_VIRTUAL]))
        consumer.constraint(a.mul(dummy_write, lv[VALUE]))

        cfc = lv[CONTEXT_FIRST_CHANGE]
        sfc = lv[SEGMENT_FIRST_CHANGE]
        vfc = lv[VIRTUAL_FIRST_CHANGE]
        unchanged = a.sub(a.sub(a.sub(one, cfc), sfc), vfc)
        rc = lv[RANGE_CHECK]

        # booleanity of the flags (incl. derived 'unchanged')
        for f in (cfc, sfc, vfc, unchanged):
            consumer.constraint(a.mul(f, a.sub(one, f)))

        # no change before the first-change column
        dc = a.sub(n_addr_c, addr_c)
        ds = a.sub(n_addr_s, addr_s)
        dv = a.sub(n_addr_v, addr_v)
        consumer.constraint_transition(a.mul(sfc, dc))
        consumer.constraint_transition(a.mul(vfc, dc))
        consumer.constraint_transition(a.mul(vfc, ds))
        consumer.constraint_transition(a.mul(unchanged, dc))
        consumer.constraint_transition(a.mul(unchanged, ds))
        consumer.constraint_transition(a.mul(unchanged, dv))

        # range_check equals the delta of the first changing column
        computed = a.add(
            a.add(a.mul(cfc, a.sub(dc, one)), a.mul(sfc, a.sub(ds, one))),
            a.add(a.mul(vfc, a.sub(dv, one)),
                  a.mul(unchanged, a.sub(n_timestamp, timestamp))))
        consumer.constraint_transition(a.sub(rc, computed))

        # read-after-write consistency at an unchanged address
        consumer.constraint_transition(
            a.mul(a.mul(n_is_read, unchanged), a.sub(n_value, value)))
