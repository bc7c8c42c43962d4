# Frozen copy of zkm_tpu_torch/tables/logic.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Logic table: AND/OR/XOR/NOR over bit-decomposed u32 operands.

Copy of zkm_tpu/tables/logic.py (zkMIPS prover/src/logic.rs), with a
vectorized `generate_rows`.  Columns: 4 op flags,
2 x 32 input bits, 1 packed result (NUM_COLUMNS = 69).  The CTL to the CPU
exports an opcode-weighted flag column plus packed operands; it also serves
KeccakSponge / ShaExtend / ShaCompress xor lookups.
"""

from __future__ import annotations

from typing import List

from ..stark.columns import Column, Filter
from ..stark.stark import Stark

IS_AND = 0
IS_OR = 1
IS_XOR = 2
IS_NOR = 3
INPUT0 = range(4, 36)
INPUT1 = range(36, 68)
RESULT = 68
NUM_COLUMNS = 69

U32_MAX = 0xFFFFFFFF

OP_AND, OP_OR, OP_XOR, OP_NOR = 0, 1, 2, 3
_FLAG_COL = {OP_AND: IS_AND, OP_OR: IS_OR, OP_XOR: IS_XOR, OP_NOR: IS_NOR}


# frozen: left out, as only the prover uses them: op_result, generate_rows.


def ctl_data() -> List[Column]:
    """Opcode-weighted flag + packed inputs + result (logic.rs:53-68)."""
    cols = [Column.linear_combination([
        (IS_AND, 0b100100 << 6), (IS_OR, 0b100101 << 6),
        (IS_XOR, 0b100110 << 6), (IS_NOR, 0b100111 << 6)])]
    cols.append(Column.le_bits(INPUT0))
    cols.append(Column.le_bits(INPUT1))
    cols.append(Column.single(RESULT))
    return cols


def ctl_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols([IS_AND, IS_OR, IS_XOR, IS_NOR]))


class LogicStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        is_and, is_or = lv[IS_AND], lv[IS_OR]
        is_xor, is_nor = lv[IS_XOR], lv[IS_NOR]
        # result = sum_coeff*(x+y) + and_coeff*(x&y) + not_coeff*u32::MAX
        sum_coeff = a.sub(a.add(is_or, is_xor), is_nor)
        and_coeff = a.add(a.sub(a.sub(is_and, is_or),
                                a.mul_const(is_xor, 2)), is_nor)
        not_coeff = is_nor

        # booleanity of all 64 input bits, as one vectorized batch
        bits = lv.rng(INPUT0.start, INPUT1.stop)
        consumer.constraint_batch(
            a.mul(bits, a.sub(bits, a.one)), INPUT1.stop - INPUT0.start)

        x = a.zero
        y = a.zero
        x_and_y = a.zero
        for i in range(32):
            xb = lv[INPUT0.start + i]
            yb = lv[INPUT1.start + i]
            w = 1 << i
            x = a.add(x, a.mul_const(xb, w))
            y = a.add(y, a.mul_const(yb, w))
            x_and_y = a.add(x_and_y, a.mul_const(a.mul(xb, yb), w))
        x_op_y = a.add(
            a.add(a.mul(sum_coeff, a.add(x, y)), a.mul(and_coeff, x_and_y)),
            a.mul_const(not_coeff, U32_MAX))
        consumer.constraint(a.sub(lv[RESULT], x_op_y))
