# Frozen copy of zkm_tpu_torch/tables/memory.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Memory table: consistency of all memory operations.

Copy of zkm_tpu/tables/memory.py (zkMIPS prover/src/memory/): 13
columns, rows sorted by (context, segment, virt, timestamp);
read-after-write equality; ordering
enforced by first-change flags + a logUp range check of the delta against a
counter column; `fill_gaps` inserts dummy reads so deltas stay below the
trace height; R0 (ctx 0, RegisterFile, virt 0) writes are value-coerced to 0.
"""

from __future__ import annotations

from typing import List

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


# frozen: left out, as only the prover uses them: MemoryOp, _fill_gaps,
# _coerce_r0, generate_rows.


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
