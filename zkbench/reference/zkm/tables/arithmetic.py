# Frozen copy of zkm_tpu_torch/tables/arithmetic.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Arithmetic table: 16-bit-limb circuits for MIPS ALU operations.

Copy of zkm_tpu/tables/arithmetic.py (zkMIPS prover/src/arithmetic/):
27 op flags, 9*N_LIMBS shared columns (N_LIMBS=2), a 2^16 range-check
counter + frequencies, and 8 AUX_EXTRA columns; every shared column is
logUp-range-checked against the counter (arithmetic_stark.rs:123-152).

Implemented op families (all of the reference's):
  * addcy (ADD/ADDU/ADDI/ADDIU/SUB/SUBU): X + Y = Z + CY*2^32 over limbs
    (addcy.rs).
  * slt (SLT/SLTU/SLTI/SLTIU): borrow chain with a sign-flip aux for the
    signed comparison (slt.rs).
  * lo_hi moves (MFHI/MTHI/MFLO/MTLO): input == output (lo_hi.rs).
  * mul / mult(u): limb products with carry aux columns (mul.rs, mult.rs).
  * div(u)/mod: two-row witness with absolute values + sign bits in the
    next row's shared columns, input0_abs = quot_abs*input1_abs + rem_abs
    with addcy-style carries (div.rs; SURVEY.md §8).
  * shifts SLL/SRL/SLLV/SRLV (shift.rs), SRA/SRAV (sra.rs), LUI (lui.rs).
"""

from __future__ import annotations

from typing import List

from ..field.goldilocks import P
from ..stark.columns import Column, Filter
from ..stark.lookup import Lookup
from ..stark.stark import Stark

LIMB_BITS = 16
N_LIMBS = 2
BASE = 1 << LIMB_BITS
# 2^-16 mod p
GOLDILOCKS_INVERSE_65536 = 18446462594437939201

# op flags (order matches arithmetic/columns.rs)
(IS_ADD, IS_ADDU, IS_ADDI, IS_ADDIU, IS_SUB, IS_SUBU, IS_MULT, IS_MULTU,
 IS_MUL, IS_DIV, IS_DIVU, IS_SLLV, IS_SRLV, IS_SRAV, IS_SLL, IS_SRL,
 IS_SRA, IS_SLT, IS_SLTU, IS_SLTI, IS_SLTIU, IS_LUI, IS_MFHI, IS_MTHI,
 IS_MFLO, IS_MTLO) = range(26)

START_SHARED_COLS = 26
NUM_SHARED_COLS = 9 * N_LIMBS
SHARED_COLS = range(START_SHARED_COLS, START_SHARED_COLS + NUM_SHARED_COLS)

def _rng(start, count):
    return range(start, start + count)

INPUT_REGISTER_0 = _rng(START_SHARED_COLS, N_LIMBS)
INPUT_REGISTER_1 = _rng(INPUT_REGISTER_0.stop, N_LIMBS)
INPUT_REGISTER_2 = _rng(INPUT_REGISTER_1.stop, N_LIMBS)
OUTPUT_REGISTER = _rng(INPUT_REGISTER_2.stop, N_LIMBS)
AUX_INPUT_REGISTER_0 = _rng(OUTPUT_REGISTER.stop, N_LIMBS)
AUX_INPUT_REGISTER_1 = _rng(AUX_INPUT_REGISTER_0.stop, N_LIMBS)
AUX_INPUT_REGISTER_2 = _rng(AUX_INPUT_REGISTER_1.stop, N_LIMBS)

RANGE_COUNTER = START_SHARED_COLS + NUM_SHARED_COLS
RC_FREQUENCIES = RANGE_COUNTER + 1
AUX_EXTRA = _rng(RC_FREQUENCIES + 1, 8)
NUM_COLUMNS = START_SHARED_COLS + NUM_SHARED_COLS + 10

RANGE_MIN_ROWS = 1 << 16   # counter must cover all 16-bit values

# mul/mult column aliases (overlapping shared-col reuse, columns.rs)
MUL_AUX_INPUT_LO = AUX_INPUT_REGISTER_0
MUL_AUX_INPUT_HI = AUX_INPUT_REGISTER_1
OUTPUT_REGISTER_LO = OUTPUT_REGISTER
OUTPUT_REGISTER_HI = _rng(OUTPUT_REGISTER.stop, N_LIMBS)
MULT_AUX_LO = _rng(OUTPUT_REGISTER_HI.stop, 2 * N_LIMBS)
MULT_AUX_HI = _rng(MULT_AUX_LO.stop, 2 * N_LIMBS)
AUX_COEFF_ABS_MAX = 1 << 20

ADDCY_OPS = {IS_ADD, IS_ADDU, IS_ADDI, IS_ADDIU, IS_SUB, IS_SUBU}
SLT_OPS = {IS_SLT, IS_SLTU, IS_SLTI, IS_SLTIU}
LO_HI_OPS = {IS_MFHI, IS_MTHI, IS_MFLO, IS_MTLO}
MUL_OPS = {IS_MUL, IS_LUI}
MULT_OPS = {IS_MULT, IS_MULTU}
SLL_OPS = {IS_SLL, IS_SLLV}
SRL_OPS = {IS_SRL, IS_SRLV}
SRA_OPS = {IS_SRA, IS_SRAV}
DIV_OPS = {IS_DIV, IS_DIVU}
HILO_RESULT_OPS = MULT_OPS | DIV_OPS   # 64-bit (hi:lo) results


# frozen: left out, as only the prover uses them: _limbs, Op, _pol_mul_lo,
# _carry_propagate, _aux_limbs, _store_aux, _gen_mul_row, _gen_mult_row,
# generate_rows, _aux_zero_poly, _store_offset_aux, _set_reg, _gen_div_core,
# _gen_div_family_rows, _finv_host.


def ctl_filter() -> Filter:
    """Any arithmetic op row (sum of all flags)."""
    return Filter.new_simple(Column.sum_cols(range(26)))


# Per-flag opcode constants exactly as the CPU reconstructs them
# (arithmetic_stark.rs:66-94 COMBINED_OPS): R-type ops are func<<6, imm ops
# are the bare opcode, MUL is opcode|func<<6.
CTL_OP_CONSTS = {
    IS_ADD: 0b100000 << 6, IS_ADDU: 0b100001 << 6, IS_ADDI: 0b001000,
    IS_ADDIU: 0b001001, IS_SUB: 0b100010 << 6, IS_SUBU: 0b100011 << 6,
    IS_MULT: 0b011000 << 6, IS_MULTU: 0b011001 << 6,
    IS_MUL: 0b011100 + (0b000010 << 6), IS_DIV: 0b011010 << 6,
    IS_DIVU: 0b011011 << 6, IS_SLLV: 0b000100 << 6, IS_SRLV: 0b000110 << 6,
    IS_SRAV: 0b000111 << 6, IS_SLL: 0, IS_SRL: 0b000010 << 6,
    IS_SRA: 0b000011 << 6, IS_SLT: 0b101010 << 6, IS_SLTU: 0b101011 << 6,
    IS_SLTI: 0b001010, IS_SLTIU: 0b001011, IS_LUI: 0b001111,
    IS_MFHI: 0b010000 << 6, IS_MTHI: 0b010001 << 6, IS_MFLO: 0b010010 << 6,
    IS_MTLO: 0b010011 << 6,
}


def ctl_data() -> List[Column]:
    """Looked-side CTL: opcode-combo column + IN0 + IN1 + OUT (packed u32s).

    Mirrors arithmetic_stark.rs ctl_arithmetic_rows: the first column pins
    the per-flag opcode<<6|func constant; operands are le-limb packed."""
    combo = Column.linear_combination(
        [(flag, const) for flag, const in CTL_OP_CONSTS.items()
         if const != 0])
    cols = [combo]
    for reg in (INPUT_REGISTER_0, INPUT_REGISTER_1, OUTPUT_REGISTER):
        cols.append(Column.linear_combination(
            [(c, 1 << (LIMB_BITS * i)) for i, c in enumerate(reg)]))
    return cols


class ArithmeticStark(Stark):
    num_columns = NUM_COLUMNS

    def lookups(self):
        return [Lookup(
            columns=tuple(Column.single(c) for c in SHARED_COLS),
            table_column=Column.single(RANGE_COUNTER),
            frequencies_column=Column.single(RC_FREQUENCIES),
            filter_columns=(None,) * NUM_SHARED_COLS)]

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one
        # range counter: starts at 0, increments by 0 or 1, ends at 2^16-1
        rc = lv[RANGE_COUNTER]
        n_rc = nv[RANGE_COUNTER]
        delta = a.sub(n_rc, rc)
        consumer.constraint_first_row(rc)
        consumer.constraint_transition(a.mul(delta, a.sub(delta, one)))
        consumer.constraint_last_row(a.sub(rc, a.constant((1 << 16) - 1)))

        self._eval_addcy(a, lv, consumer)
        self._eval_slt(a, lv, consumer)
        self._eval_lo_hi(a, lv, consumer)
        self._eval_mul_family(a, lv, consumer)
        self._eval_mult_family(a, lv, consumer)
        self._eval_divu(a, lv, consumer)
        self._eval_div(a, lv, nv, consumer)
        self._eval_right_shift(a, lv, nv, consumer)
        self._eval_sll_power_chain(a, lv, consumer)

    # -- addcy: X + Y == Z + CY * 2^32 --------------------------------------

    def _addcy_chain(self, a, consumer, filt, x, y, z, given_cy,
                     check_cy_bit=True):
        overflow = a.constant(BASE)
        cy = a.zero
        for xi, yi, zi in zip(x, y, z):
            t = a.sub(a.add(a.add(cy, xi), yi), zi)
            consumer.constraint(
                a.mul(filt, a.mul(t, a.sub(overflow, t))))
            cy = a.mul_const(t, GOLDILOCKS_INVERSE_65536)
        if check_cy_bit:
            consumer.constraint(
                a.mul(filt, a.mul(given_cy[0], a.sub(given_cy[0], a.one))))
        consumer.constraint(a.mul(filt, a.sub(cy, given_cy[0])))
        for g in given_cy[1:]:
            consumer.constraint(a.mul(filt, g))

    def _eval_addcy(self, a, lv, consumer):
        in0 = [lv[c] for c in INPUT_REGISTER_0]
        in1 = [lv[c] for c in INPUT_REGISTER_1]
        out = [lv[c] for c in OUTPUT_REGISTER]
        aux = [lv[c] for c in AUX_INPUT_REGISTER_0]
        is_add = a.add(a.add(lv[IS_ADD], lv[IS_ADDI]),
                       a.add(lv[IS_ADDU], lv[IS_ADDIU]))
        is_sub = a.add(lv[IS_SUB], lv[IS_SUBU])
        self._addcy_chain(a, consumer, is_add, in0, in1, out, aux)
        # SUB: out + in1 = in0 + cy*2^32
        self._addcy_chain(a, consumer, is_sub, in1, out, in0, aux)

    # -- slt: borrow chain with sign handling (slt.rs) ----------------------

    def _eval_slt(self, a, lv, consumer):
        one = a.one
        is_lt = a.add(a.add(lv[IS_SLT], lv[IS_SLTU]),
                      a.add(lv[IS_SLTI], lv[IS_SLTIU]))
        sign = a.add(lv[IS_SLT], lv[IS_SLTI])
        x = [lv[c] for c in INPUT_REGISTER_1]      # right
        y = [lv[c] for c in AUX_INPUT_REGISTER_0]  # diff = left - right
        z = [lv[c] for c in INPUT_REGISTER_0]      # left
        given_cy = [lv[c] for c in AUX_INPUT_REGISTER_1]
        rd = [lv[c] for c in OUTPUT_REGISTER]

        overflow = a.constant(BASE)
        cy = a.zero
        for xi, yi, zi in zip(x, y, z):
            t = a.sub(a.add(a.add(cy, xi), yi), zi)
            consumer.constraint(
                a.mul(is_lt, a.mul(t, a.sub(overflow, t))))
            cy = a.mul_const(t, GOLDILOCKS_INVERSE_65536)

        consumer.constraint(
            a.mul(is_lt, a.mul(given_cy[0], a.sub(given_cy[0], one))))
        consumer.constraint(
            a.mul(is_lt, a.mul(a.sub(cy, given_cy[0]), a.sub(one, sign))))
        consumer.constraint(
            a.mul(is_lt, a.mul(given_cy[1],
                               a.sub(a.sub(one, cy), given_cy[0]))))
        consumer.constraint_transition(
            a.mul(is_lt, a.sub(rd[0], given_cy[0])))
        for i in range(1, N_LIMBS):
            consumer.constraint(
                a.mul(is_lt, a.mul(given_cy[i], a.sub(one, sign))))
            consumer.constraint_transition(a.mul(is_lt, rd[i]))

    # -- mul family: c(x) == a(x)b(x) - (x - beta) s(x)  (mul.rs) ----------

    def _aux_from_cols(self, a, lv, lo_range, hi_range, count):
        return [a.sub(a.add(lv[lo_range.start + i],
                            a.mul_const(lv[hi_range.start + i], BASE)),
                      a.constant(AUX_COEFF_ABS_MAX))
                for i in range(count)]

    def _eval_product_check(self, a, consumer, filt, left, right, out, aux):
        """pol_mul_lo(left,right) - out - (x - beta)*aux == 0 coeff-wise."""
        n = len(left)
        for d in range(n):
            acc = a.zero
            for i in range(d + 1):
                acc = a.add(acc, a.mul(left[i], right[d - i]))
            acc = a.sub(acc, out[d])
            if d == 0:
                adjoin = a.mul_const(aux[0], P - BASE)
            else:
                adjoin = a.sub(aux[d - 1], a.mul_const(aux[d], BASE))
            acc = a.sub(acc, adjoin)
            consumer.constraint(a.mul(filt, acc))

    def _eval_mul_family(self, a, lv, consumer):
        left = [lv[c] for c in INPUT_REGISTER_0]
        right = [lv[c] for c in INPUT_REGISTER_1]
        out = [lv[c] for c in OUTPUT_REGISTER]
        aux = self._aux_from_cols(a, lv, MUL_AUX_INPUT_LO, MUL_AUX_INPUT_HI,
                                  N_LIMBS)
        for flag in (IS_MUL, IS_LUI):
            self._eval_product_check(a, consumer, lv[flag], left, right,
                                     out, aux)
        # SLL(V): value (IN1) * shifted displacement (IN2) via the same aux
        sll = a.add(lv[IS_SLL], lv[IS_SLLV])
        in2 = [lv[c] for c in INPUT_REGISTER_2]
        self._eval_product_check(a, consumer, sll, right, in2, out, aux)

    # -- mult family: 64-bit product into hi:lo (mult.rs) -------------------

    def _eval_mult_family(self, a, lv, consumer):
        one = a.one
        in0 = [lv[c] for c in INPUT_REGISTER_0]
        in1 = [lv[c] for c in INPUT_REGISTER_1]
        out = [lv[c] for c in OUTPUT_REGISTER_LO] + \
            [lv[c] for c in OUTPUT_REGISTER_HI]
        aux = self._aux_from_cols(a, lv, MULT_AUX_LO, MULT_AUX_HI,
                                  2 * N_LIMBS)

        # MULT (signed): witness sign bits + range-checked sum columns
        filt = lv[IS_MULT]

        def sign_extend(is_neg_col, sum_col, limbs):
            is_neg = lv[is_neg_col]
            consumer.constraint(a.mul(filt, a.mul(is_neg, a.sub(one, is_neg))))
            s = lv[sum_col]
            hi = limbs[N_LIMBS - 1]
            consumer.constraint(a.mul(filt, a.sub(
                a.add(hi, a.constant(1 << (LIMB_BITS - 1))),
                a.add(s, a.mul_const(is_neg, BASE)))))
            pad = a.mul_const(is_neg, 0xFFFF)
            return limbs + [pad] * N_LIMBS

        left = sign_extend(AUX_EXTRA.start, INPUT_REGISTER_2.start, in0)
        right = sign_extend(AUX_EXTRA.start + 1, INPUT_REGISTER_2.start + 1,
                            in1)
        self._eval_product_check(a, consumer, filt, left, right, out, aux)

        # MULTU (unsigned): zero-extended inputs
        z = a.zero
        self._eval_product_check(a, consumer, lv[IS_MULTU],
                                 in0 + [z] * N_LIMBS, in1 + [z] * N_LIMBS,
                                 out, aux)

    # -- lo/hi moves --------------------------------------------------------

    def _eval_lo_hi(self, a, lv, consumer):
        filt = a.add(a.add(lv[IS_MFHI], lv[IS_MTHI]),
                     a.add(lv[IS_MFLO], lv[IS_MTLO]))
        for ci, co in zip(INPUT_REGISTER_0, OUTPUT_REGISTER):
            consumer.constraint(a.mul(filt, a.sub(lv[ci], lv[co])))


# ---------------------------------------------------------------------------
# DIV/DIVU and right-shift families (SRL/SRLV/SRA/SRAV).
#
# Original TPU-side design replacing the reference's modular-op machinery
# (arithmetic/div.rs:18-192, sra.rs, shift.rs) with direct witness
# equations — same statements proven, far fewer columns/constraints:
#
#   DIVU (1 row):  N = Q*D + R   (4-position limb identity w/ carry aux),
#                  R < D when D != 0 (borrow chain), else Q=0, R=N.
#   DIV  (2 rows): |N| = |Q|*|D| + |R| on witnessed absolute values with
#                  sign bits bound via a range-checked top-limb sum;
#                  sign(Q)=sign(N)^sign(D) unless Q=0; sign(R)=sign(N)
#                  unless R=0; |R| < |D| or D=0.
#   SRL/SRA (2 rows): x = y*2^s + r, r < 2^s, with 2^(s&31) built by a
#                  constrained 5-bit power chain (closes the reference gap
#                  where the 1<<s register is a free witness); SRA adds
#                  result = y + x_neg*(2^32 - 2*w31), w31*2^s = 2^31.
#
# Row-2 ("continuation") shared columns hold aux values; they carry no op
# flag, so only the range check applies to them.
# ---------------------------------------------------------------------------

# lv AUX_EXTRA roles (DIV/DIVU): [0]=opp, [2]=d_nz, [3]=Dinv,
#   [4]=n_neg, [5]=d_neg, [6]=q_neg, [7]=r_neg
# lv AUX_EXTRA roles (shifts):   [0..4]=shift bits, [5]=x_neg
EX_OPP, EX_DNZ, EX_DINV = AUX_EXTRA.start, AUX_EXTRA.start + 2, \
    AUX_EXTRA.start + 3
EX_NNEG, EX_DNEG, EX_QNEG, EX_RNEG = (AUX_EXTRA.start + i
                                      for i in range(4, 8))
EX_SHIFT_BITS = range(AUX_EXTRA.start, AUX_EXTRA.start + 5)
EX_XNEG = AUX_EXTRA.start + 5

# shift lv shared layout: IN0=s, IN1=x, IN2=2^s, OUT=result,
#   AUX0=y, AUX1=r, AUX2=slack, [14,15]=high, [16,17]=w31
SH_HIGH = _rng(MULT_AUX_LO.stop, 2)          # shared cols 14-15
SH_W31 = _rng(SH_HIGH.stop, 2)               # shared cols 16-17
# shift nv row: [0]=x_sum, [1..3]=power-chain intermediates c1..c3
NV_XSUM = START_SHARED_COLS
NV_C = [START_SHARED_COLS + 1 + i for i in range(3)]
# div nv row: IN0=|N|, IN1=|D|, IN2=|Q|, OUT=|R|, AUX0=slack,
#   [10..13]=top-limb sums for N,D,Q,R
DIV_SUMS = _rng(MULT_AUX_LO.start, 4)


# SLL single-row power-chain columns (free slots in the mul layout)
SLL_HIGH = AUX_INPUT_REGISTER_2              # shared 12-13
SLL_C = [MULT_AUX_HI.start, MULT_AUX_HI.start + 1, MULT_AUX_HI.start + 2]

_POW_TERM = [(1 << (1 << i)) - 1 for i in range(5)]   # 1,3,15,255,65535


def _mixin_div_shift(cls):
    """Constraint methods for the div/right-shift families (appended to
    ArithmeticStark below; kept out of the class body for readability)."""

    def _p(self, a, v, rng_):
        return a.add(v[rng_.start], a.mul_const(v[rng_.start + 1], BASE))

    def _eval_product_acc(self, a, consumer, filt, left, right, addend,
                          out, aux):
        """pol_mul_lo(left,right) + addend - out - (x-2^16)*aux == 0."""
        n = len(left)
        for d in range(n):
            acc = a.zero
            for i in range(d + 1):
                acc = a.add(acc, a.mul(left[i], right[d - i]))
            acc = a.add(acc, addend[d])
            acc = a.sub(acc, out[d])
            if d == 0:
                adjoin = a.mul_const(aux[0], P - BASE)
            else:
                adjoin = a.sub(aux[d - 1], a.mul_const(aux[d], BASE))
            acc = a.sub(acc, adjoin)
            consumer.constraint(a.mul(filt, acc))

    def _borrow_chain(self, a, consumer, filt, x, s, d):
        """x + s + 1 == d + cy*2^32 over limbs; returns cy (deg 1)."""
        one = a.one
        cy = a.zero
        for i in range(N_LIMBS):
            t = a.sub(a.add(a.add(cy, x[i]), s[i]), d[i])
            if i == 0:
                t = a.add(t, one)
            consumer.constraint(
                a.mul(filt, a.mul(t, a.sub(a.constant(BASE), t))))
            cy = a.mul_const(t, GOLDILOCKS_INVERSE_65536)
        return cy

    def _div_core(self, a, lv, consumer, filt, q_l, d_l, r_l, n_l,
                  d_packed, q_packed, r_packed, n_packed):
        """Shared N = Q*D + R, R < D (or D=0 => Q=0, R=N) machinery."""
        one = a.one
        z = a.zero
        aux = self._aux_from_cols(a, lv, MULT_AUX_LO, MULT_AUX_HI,
                                  2 * N_LIMBS)
        self._eval_product_acc(
            a, consumer, filt, q_l + [z, z], d_l + [z, z],
            r_l + [z, z], n_l + [z, z], aux)
        dnz = lv[EX_DNZ]
        dinv = lv[EX_DINV]
        consumer.constraint(a.mul(filt, a.sub(dnz, a.mul(d_packed, dinv))))
        consumer.constraint(a.mul(filt, a.mul(d_packed, a.sub(one, dnz))))
        slack = [lv[c] for c in INPUT_REGISTER_2]
        cy = self._borrow_chain(a, consumer, filt, r_l, slack, d_l)
        consumer.constraint(a.mul(filt, a.sub(cy, a.sub(one, dnz))))
        consumer.constraint(a.mul(filt, a.mul(a.sub(one, dnz), q_packed)))
        consumer.constraint(a.mul(filt, a.mul(
            a.sub(one, dnz), a.sub(r_packed, n_packed))))

    def _eval_divu(self, a, lv, consumer):
        filt = lv[IS_DIVU]
        n_l = [lv[c] for c in INPUT_REGISTER_0]
        d_l = [lv[c] for c in INPUT_REGISTER_1]
        q_l = [lv[c] for c in OUTPUT_REGISTER]
        r_l = [lv[c] for c in AUX_INPUT_REGISTER_0]
        self._div_core(a, lv, consumer, filt, q_l, d_l, r_l, n_l,
                       self._p(a, lv, INPUT_REGISTER_1),
                       self._p(a, lv, OUTPUT_REGISTER),
                       self._p(a, lv, AUX_INPUT_REGISTER_0),
                       self._p(a, lv, INPUT_REGISTER_0))

    def _eval_div(self, a, lv, nv, consumer):
        one = a.one
        filt = lv[IS_DIV]
        N = self._p(a, lv, INPUT_REGISTER_0)
        D = self._p(a, lv, INPUT_REGISTER_1)
        Q = self._p(a, lv, OUTPUT_REGISTER)
        R = self._p(a, lv, AUX_INPUT_REGISTER_0)
        aN = self._p(a, nv, INPUT_REGISTER_0)
        aD = self._p(a, nv, INPUT_REGISTER_1)
        aQ = self._p(a, nv, INPUT_REGISTER_2)
        aR = self._p(a, nv, OUTPUT_REGISTER)
        n_neg, d_neg = lv[EX_NNEG], lv[EX_DNEG]
        q_neg, r_neg = lv[EX_QNEG], lv[EX_RNEG]
        opp = lv[EX_OPP]
        for b in (n_neg, d_neg, q_neg, r_neg, opp):
            consumer.constraint(a.mul(filt, a.mul(b, a.sub(one, b))))
        # top-limb sum trick binds n_neg/d_neg to the actual sign bits
        half = a.constant(1 << 15)
        consumer.constraint(a.mul(filt, a.sub(
            a.add(lv[INPUT_REGISTER_0.start + 1], half),
            a.add(nv[DIV_SUMS.start], a.mul_const(n_neg, BASE)))))
        consumer.constraint(a.mul(filt, a.sub(
            a.add(lv[INPUT_REGISTER_1.start + 1], half),
            a.add(nv[DIV_SUMS.start + 1], a.mul_const(d_neg, BASE)))))
        # abs reconstruction: X = |X|*(1-2neg) + 2^32*neg
        p32 = (1 << 32) % P
        for X, aX, neg in ((N, aN, n_neg), (D, aD, d_neg), (Q, aQ, q_neg),
                           (R, aR, r_neg)):
            recon = a.add(a.sub(aX, a.mul_const(a.mul(neg, aX), 2)),
                          a.mul_const(neg, p32))
            consumer.constraint(a.mul(filt, a.sub(X, recon)))
        # |N| = |Q|*|D| + |R|, |R| < |D| (or D == 0)
        q_l = [nv[c] for c in INPUT_REGISTER_2]
        d_l = [nv[c] for c in INPUT_REGISTER_1]
        r_l = [nv[c] for c in OUTPUT_REGISTER]
        n_l = [nv[c] for c in INPUT_REGISTER_0]
        self._div_core(a, lv, consumer, filt, q_l, d_l, r_l, n_l,
                       aD, Q, R, N)
        # sign coherence
        consumer.constraint(a.mul(filt, a.sub(
            opp, a.sub(a.add(n_neg, d_neg),
                       a.mul_const(a.mul(n_neg, d_neg), 2)))))
        consumer.constraint(a.mul(filt, a.mul(a.sub(q_neg, opp), aQ)))
        consumer.constraint(a.mul(filt, a.mul(a.sub(r_neg, n_neg), aR)))

    def _power_chain(self, a, consumer, filt, bits, c_cols, p2):
        """c1=T0*T1, c2=c1*T2, c3=c2*T3, p2=c3*T4 with T_i=1+b_i*(2^2^i-1)."""
        one = a.one
        terms = [a.add(one, a.mul_const(bits[i], _POW_TERM[i]))
                 for i in range(5)]
        consumer.constraint(a.mul(filt, a.sub(
            c_cols[0], a.mul(terms[0], terms[1]))))
        consumer.constraint(a.mul(filt, a.sub(
            c_cols[1], a.mul(c_cols[0], terms[2]))))
        consumer.constraint(a.mul(filt, a.sub(
            c_cols[2], a.mul(c_cols[1], terms[3]))))
        consumer.constraint(a.mul(filt, a.sub(
            p2, a.mul(c_cols[2], terms[4]))))

    def _shift_decomp(self, a, lv, consumer, filt, bits, high_rng):
        """IN0 (the full shift amount) == sum(bits) + 32*high."""
        low = a.zero
        for i in range(5):
            consumer.constraint(a.mul(filt, a.mul(
                bits[i], a.sub(a.one, bits[i]))))
            low = a.add(low, a.mul_const(bits[i], 1 << i))
        s = self._p(a, lv, INPUT_REGISTER_0)
        high = self._p(a, lv, high_rng)
        consumer.constraint(a.mul(filt, a.sub(
            s, a.add(low, a.mul_const(high, 32)))))
        return low

    def _eval_right_shift(self, a, lv, nv, consumer):
        one = a.one
        f_srl = a.add(lv[IS_SRL], lv[IS_SRLV])
        f_sra = a.add(lv[IS_SRA], lv[IS_SRAV])
        filt = a.add(f_srl, f_sra)
        bits = [lv[c] for c in EX_SHIFT_BITS]
        self._shift_decomp(a, lv, consumer, filt, bits, SH_HIGH)
        c_cols = [nv[c] for c in NV_C]
        p2 = self._p(a, lv, INPUT_REGISTER_2)
        self._power_chain(a, consumer, filt, bits, c_cols, p2)

        x = self._p(a, lv, INPUT_REGISTER_1)
        res = self._p(a, lv, OUTPUT_REGISTER)
        y = self._p(a, lv, AUX_INPUT_REGISTER_0)
        r_l = [lv[c] for c in AUX_INPUT_REGISTER_1]
        s_l = [lv[c] for c in AUX_INPUT_REGISTER_2]
        p2_l = [lv[c] for c in INPUT_REGISTER_2]
        r = self._p(a, lv, AUX_INPUT_REGISTER_1)
        # x = y * 2^s + r (y < 2^32, 2^s <= 2^31: no field wrap)
        consumer.constraint(a.mul(filt, a.sub(a.add(a.mul(y, p2), r), x)))
        # r < 2^s
        cy = self._borrow_chain(a, consumer, filt, r_l, s_l, p2_l)
        consumer.constraint(a.mul(filt, cy))
        # SRL result
        consumer.constraint(a.mul(f_srl, a.sub(res, y)))
        # SRA: result = y + x_neg*(2^32 - 2*w31), w31*2^s = 2^31
        xn = lv[EX_XNEG]
        consumer.constraint(a.mul(f_sra, a.mul(xn, a.sub(one, xn))))
        half = a.constant(1 << 15)
        consumer.constraint(a.mul(f_sra, a.sub(
            a.add(lv[INPUT_REGISTER_1.start + 1], half),
            a.add(nv[NV_XSUM], a.mul_const(xn, BASE)))))
        w31 = self._p(a, lv, SH_W31)
        consumer.constraint(a.mul(f_sra, a.sub(
            a.mul(w31, p2), a.constant(1 << 31))))
        corr = a.sub(a.mul_const(xn, (1 << 32) % P),
                     a.mul_const(a.mul(xn, w31), 2))
        consumer.constraint(a.mul(f_sra, a.sub(res, a.add(y, corr))))

    def _eval_sll_power_chain(self, a, lv, consumer):
        """Binds the SLL/SLLV 1<<shift register (IN2) to the shift amount
        (IN0) — the reference leaves IN2 a free witness (shift.rs:58)."""
        filt = a.add(lv[IS_SLL], lv[IS_SLLV])
        bits = [lv[c] for c in EX_SHIFT_BITS]
        self._shift_decomp(a, lv, consumer, filt, bits, SLL_HIGH)
        c_cols = [lv[c] for c in SLL_C]
        p2 = self._p(a, lv, INPUT_REGISTER_2)
        self._power_chain(a, consumer, filt, bits, c_cols, p2)

    for name, fn in list(locals().items()):
        if callable(fn):
            setattr(cls, name, fn)
    return cls


_mixin_div_shift(ArithmeticStark)
