# Frozen copy of zkm_tpu_torch/tables/sha_extend_sponge.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""ShaExtendSponge table: memory interface for one SHA-256 extend step.

Copy of zkm_tpu/tables/sha_extend_sponge.py (zkMIPS
prover/src/sha_extend_sponge/).  One row per
extend step; binds the four input words to memory reads, the computation
to the ShaExtend table (input/output CTLs keyed by timestamp), and the
result to the CPU's sponge row.

Deviations of zkm_tpu (and so of this copy) from zkMIPS:
  * Word-level memory CTLs (zkMIPS reads 16 bytes byte-wise).
  * Input addresses are *derived* from the output address by constraint-
    free linear column combinations (virt_out - 60/-8/-64/-28), pinning
    the w[i-15]/w[i-2]/w[i-16]/w[i-7] access pattern exactly.
  * A 5th memory CTL *reads back* the written w[i] at the sponge
    timestamp, binding the CPU's GP-channel write value to the proven
    output (zkMIPS leaves the written value unbound to the sponge
    digest — soundness-increasing).
"""

from __future__ import annotations

from typing import List

from ..stark.columns import Column, Filter
from ..stark.stark import Stark

CONTEXT = 0
SEGMENT = 1
VIRT_OUT = 2
TIMESTAMP = 3
W15 = 4
W2 = 5
W16 = 6
W7 = 7
OUTPUT = 8
IS_REAL = 9
NUM_COLUMNS = 10

# byte offsets of the 4 inputs relative to the output address w_ptr + 4i:
# w[i-15], w[i-2], w[i-16], w[i-7]
INPUT_OFFSETS = (-60, -8, -64, -28)
INPUT_COLS = (W15, W2, W16, W7)


# frozen: left out, as only the prover uses them: generate_rows.


def ctl_looked_data() -> List[Column]:
    """CPU sponge row <-> this row: (ctx, seg, virt_out, ts, w_i)."""
    return Column.singles([CONTEXT, SEGMENT, VIRT_OUT, TIMESTAMP, OUTPUT])


def ctl_looked_filter() -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


def ctl_looking_extend_inputs() -> List[Column]:
    return Column.singles([W15, W2, W16, W7, TIMESTAMP])


def ctl_looking_extend_outputs() -> List[Column]:
    return Column.singles([OUTPUT, TIMESTAMP])


def ctl_looking_extend_filter() -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


def ctl_looking_memory(i: int) -> List[Column]:
    """i in 0..3: input word read at virt_out + INPUT_OFFSETS[i];
    i == 4: read-back of the written w[i] at virt_out."""
    if i < 4:
        addr = Column.linear_combination_with_constant(
            [(VIRT_OUT, 1)], INPUT_OFFSETS[i])
        value = Column.single(INPUT_COLS[i])
    else:
        addr = Column.single(VIRT_OUT)
        value = Column.single(OUTPUT)
    return [Column.one(), Column.single(CONTEXT), Column.single(SEGMENT),
            addr, value, Column.single(TIMESTAMP)]


NUM_MEMORY_CTLS = 5


def ctl_looking_memory_filter(i: int) -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


class ShaExtendSpongeStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        is_real = lv[IS_REAL]
        consumer.constraint(a.mul(is_real, a.sub(is_real, a.one)))
