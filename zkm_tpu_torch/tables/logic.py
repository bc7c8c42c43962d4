"""Logic table: AND/OR/XOR/NOR over bit-decomposed u32 operands.

Copy of zkm_tpu/tables/logic.py (zkMIPS prover/src/logic.rs), with a
vectorized `generate_rows`.  Columns: 4 op flags,
2 x 32 input bits, 1 packed result (NUM_COLUMNS = 69).  The CTL to the CPU
exports an opcode-weighted flag column plus packed operands; it also serves
KeccakSponge / ShaExtend / ShaCompress xor lookups.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

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


def op_result(op: int, a: int, b: int) -> int:
    if op == OP_AND:
        return a & b
    if op == OP_OR:
        return a | b
    if op == OP_XOR:
        return a ^ b
    return (~(a | b)) & U32_MAX


def generate_rows(operations: Sequence[Tuple[int, int, int]],
                  min_rows: int = 64) -> np.ndarray:
    """operations: (op, input0, input1) u32 tuples -> (NUM_COLUMNS, N) u64
    rows, N the next power of two >= max(len, min_rows, 2).  Vectorized;
    equal to the reference's row-by-row builder."""
    ops = np.asarray(operations, dtype=np.uint64).reshape(-1, 3)
    k = ops.shape[0]
    n = max(k, min_rows, 2)
    n = 1 << (n - 1).bit_length()
    rows = np.zeros((n, NUM_COLUMNS), dtype=np.uint64)
    if k:
        op = ops[:, 0].astype(np.int64)
        a, b = ops[:, 1], ops[:, 2]
        flag = np.array([_FLAG_COL[i] for i in range(4)])[op]
        rows[np.arange(k), flag] = 1
        shifts = np.arange(32, dtype=np.uint64)
        rows[:k, INPUT0.start:INPUT0.stop] = (a[:, None] >> shifts) & 1
        rows[:k, INPUT1.start:INPUT1.stop] = (b[:, None] >> shifts) & 1
        rows[:k, RESULT] = np.select(
            [op == OP_AND, op == OP_OR, op == OP_XOR],
            [a & b, a | b, a ^ b], ~(a | b) & np.uint64(U32_MAX))
    return rows.T.copy()


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
