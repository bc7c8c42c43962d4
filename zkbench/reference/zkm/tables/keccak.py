# Frozen copy of zkm_tpu_torch/tables/keccak.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Keccak-f[1600] permutation table: 24 rows per permutation.

Copy of zkm_tpu/tables/keccak.py (zkMIPS prover/src/keccak/{columns.rs,
keccak_stark.rs,round_flags.rs,logic.rs}).  Column layout matches zkMIPS
exactly (NUM_COLUMNS = 2431): 24 round flags, timestamp, A limbs (25 x lo/hi u32),
C / C' / A' bit slices, A'' limbs, A''[0,0] bits, A'''[0,0] limbs.

Notes (zkm_tpu's, and so this copy's):
  * Trace generation is fully vectorized numpy over all permutations at
    once (uint64 lane ops + bit extraction) — no per-bit Python loops.
  * zkMIPS DISABLES its round-flag constraints
    (keccak_stark.rs:256 comments out eval_round_flags), leaving the
    round constants effectively unconstrained — a prover could inject an
    arbitrary "RC" via non-one-hot flags.  We enable the round-flag group
    and additionally pin booleanity of every flag and of their sum, with
    the first-row constraint gated on any-flag so an all-padding (empty)
    table stays provable.  Deviation is soundness-increasing.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..hash.keccak import _ROUND_CONSTANTS as RC, _ROTATIONS as R
from ..stark.columns import Column, Filter
from ..stark.stark import Stark

NUM_ROUNDS = 24
NUM_INPUTS = 25

# -- column layout (columns.rs) ---------------------------------------------


def reg_step(r: int) -> int:
    return r


TIMESTAMP = NUM_ROUNDS                       # 24
START_A = TIMESTAMP + 1                      # 25


def reg_a(x: int, y: int) -> int:
    return START_A + (x * 5 + y) * 2


START_C = START_A + 5 * 5 * 2                # 75


def reg_c(x: int, z: int) -> int:
    return START_C + x * 64 + z


START_C_PRIME = START_C + 5 * 64             # 395


def reg_c_prime(x: int, z: int) -> int:
    return START_C_PRIME + x * 64 + z


START_A_PRIME = START_C_PRIME + 5 * 64       # 715


def reg_a_prime(x: int, y: int, z: int) -> int:
    return START_A_PRIME + x * 64 * 5 + y * 64 + z


def reg_b(x: int, y: int, z: int) -> int:
    # B is a rotation of A': B[x, y] = ROT(A'[a, b], R[a][b]),
    # a = (x + 3y) % 5, b = x (columns.rs:90-104)
    a = (x + 3 * y) % 5
    b = x
    rot = R[a][b]
    return reg_a_prime(a, b, (z + 64 - rot) % 64)


START_A_PRIME_PRIME = START_A_PRIME + 5 * 5 * 64     # 2315


def reg_a_prime_prime(x: int, y: int) -> int:
    return START_A_PRIME_PRIME + x * 2 * 5 + y * 2


START_A_PRIME_PRIME_0_0_BITS = START_A_PRIME_PRIME + 5 * 5 * 2   # 2365


def reg_a_prime_prime_0_0_bit(i: int) -> int:
    return START_A_PRIME_PRIME_0_0_BITS + i


REG_A_PRIME_PRIME_PRIME_0_0_LO = START_A_PRIME_PRIME_0_0_BITS + 64  # 2429
REG_A_PRIME_PRIME_PRIME_0_0_HI = REG_A_PRIME_PRIME_PRIME_0_0_LO + 1


def reg_a_prime_prime_prime(x: int, y: int) -> int:
    if x == 0 and y == 0:
        return REG_A_PRIME_PRIME_PRIME_0_0_LO
    return reg_a_prime_prime(x, y)


NUM_COLUMNS = REG_A_PRIME_PRIME_PRIME_0_0_HI + 1     # 2431

RC_BITS = np.array([[(rc >> i) & 1 for i in range(64)] for rc in RC],
                   dtype=np.uint64)          # (24, 64)

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    if n == 0:
        return v
    return (v << np.uint64(n)) | (v >> np.uint64(64 - n))


# frozen: left out, as only the prover uses them: _bits64, generate_rows.


# -- trace generation --------------------------------------------------------

# -- CTL exports (keccak_stark.rs:34-52) -------------------------------------

def ctl_data_inputs() -> List[Column]:
    cols = []
    for i in range(2 * NUM_INPUTS):
        i64 = i // 2
        y, x = i64 // 5, i64 % 5
        cols.append(Column.single(reg_a(x, y) + i % 2))
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_data_outputs() -> List[Column]:
    cols = []
    for i in range(2 * NUM_INPUTS):
        i64 = i // 2
        y, x = i64 // 5, i64 % 5
        cols.append(Column.single(reg_a_prime_prime_prime(x, y) + i % 2))
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_filter_inputs() -> Filter:
    return Filter.new_simple(Column.single(reg_step(0)))


def ctl_filter_outputs() -> Filter:
    return Filter.new_simple(Column.single(reg_step(NUM_ROUNDS - 1)))


# -- constraints -------------------------------------------------------------

def _xor_gen(a, x, y):
    return a.sub(a.add(x, y), a.mul_const(a.mul(x, y), 2))


def _xor3_gen(a, x, y, z):
    return _xor_gen(a, x, _xor_gen(a, y, z))


def _andn_gen(a, x, y):
    return a.mul(a.sub(a.one, x), y)


class KeccakStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one

        # round flags (round_flags.rs, enabled here — see module docstring)
        flags = [lv[reg_step(r)] for r in range(NUM_ROUNDS)]
        nflags = [nv[reg_step(r)] for r in range(NUM_ROUNDS)]
        any_flag = flags[0]
        for f in flags[1:]:
            any_flag = a.add(any_flag, f)
        next_any = nflags[0]
        for f in nflags[1:]:
            next_any = a.add(next_any, f)
        for f in flags:
            consumer.constraint(a.mul(f, a.sub(f, one)))
        consumer.constraint(a.mul(any_flag, a.sub(any_flag, one)))
        # first row: round 0 (or an entirely-empty table)
        consumer.constraint_first_row(
            a.mul(any_flag, a.sub(lv[reg_step(0)], one)))
        for r in range(1, NUM_ROUNDS):
            consumer.constraint_first_row(lv[reg_step(r)])
        # flags circularly increment (or next row is padding)
        for r in range(NUM_ROUNDS):
            consumer.constraint_transition(a.mul(
                next_any,
                a.sub(nflags[(r + 1) % NUM_ROUNDS], flags[r])))
        # padding rows are final
        consumer.constraint_transition(
            a.mul(next_any, a.sub(any_flag, one)))

        # timestamp constant within a permutation
        final_step = flags[NUM_ROUNDS - 1]
        not_final = a.sub(one, final_step)
        consumer.constraint(a.mul(
            a.mul(any_flag, not_final),
            a.sub(nv[TIMESTAMP], lv[TIMESTAMP])))

        # C'[x, z] = xor(C[x, z], C[x-1, z], C[x+1, z-1])
        for x in range(5):
            for z in range(64):
                xor = _xor3_gen(a, lv[reg_c(x, z)],
                                lv[reg_c((x + 4) % 5, z)],
                                lv[reg_c((x + 1) % 5, (z + 63) % 64)])
                consumer.constraint(a.sub(lv[reg_c_prime(x, z)], xor))

        # A limbs match xor(A', C, C') bit recombination
        for x in range(5):
            for y in range(5):
                lo = a.zero
                hi = a.zero
                for z in reversed(range(32)):
                    bit = _xor3_gen(a, lv[reg_a_prime(x, y, z)],
                                    lv[reg_c(x, z)], lv[reg_c_prime(x, z)])
                    lo = a.add(a.mul_const(lo, 2), bit)
                for z in reversed(range(32, 64)):
                    bit = _xor3_gen(a, lv[reg_a_prime(x, y, z)],
                                    lv[reg_c(x, z)], lv[reg_c_prime(x, z)])
                    hi = a.add(a.mul_const(hi, 2), bit)
                consumer.constraint(a.sub(lo, lv[reg_a(x, y)]))
                consumer.constraint(a.sub(hi, lv[reg_a(x, y) + 1]))

        # xor parity: diff(diff-2)(diff-4) = 0 with
        # diff = sum_y A'[x, y, z] - C'[x, z]
        for x in range(5):
            for z in range(64):
                s = lv[reg_a_prime(x, 0, z)]
                for y in range(1, 5):
                    s = a.add(s, lv[reg_a_prime(x, y, z)])
                diff = a.sub(s, lv[reg_c_prime(x, z)])
                consumer.constraint(a.mul(
                    a.mul(diff, a.add_const(diff, -2)),
                    a.add_const(diff, -4)))

        # A''[x, y] = xor(B[x, y], andn(B[x+1, y], B[x+2, y])) recombined
        for x in range(5):
            for y in range(5):
                lo = a.zero
                hi = a.zero
                for z in reversed(range(32)):
                    bit = _xor_gen(
                        a, lv[reg_b(x, y, z)],
                        _andn_gen(a, lv[reg_b((x + 1) % 5, y, z)],
                                  lv[reg_b((x + 2) % 5, y, z)]))
                    lo = a.add(a.mul_const(lo, 2), bit)
                for z in reversed(range(32, 64)):
                    bit = _xor_gen(
                        a, lv[reg_b(x, y, z)],
                        _andn_gen(a, lv[reg_b((x + 1) % 5, y, z)],
                                  lv[reg_b((x + 2) % 5, y, z)]))
                    hi = a.add(a.mul_const(hi, 2), bit)
                consumer.constraint(a.sub(lo, lv[reg_a_prime_prime(x, y)]))
                consumer.constraint(
                    a.sub(hi, lv[reg_a_prime_prime(x, y) + 1]))

        # A''[0, 0] bits: boolean + recombine to the stored limbs
        bits00 = [lv[reg_a_prime_prime_0_0_bit(i)] for i in range(64)]
        for b in bits00:
            consumer.constraint(a.mul(b, a.sub(b, one)))
        lo = a.zero
        hi = a.zero
        for z in reversed(range(32)):
            lo = a.add(a.mul_const(lo, 2), bits00[z])
        for z in reversed(range(32, 64)):
            hi = a.add(a.mul_const(hi, 2), bits00[z])
        consumer.constraint(a.sub(lo, lv[reg_a_prime_prime(0, 0)]))
        consumer.constraint(a.sub(hi, lv[reg_a_prime_prime(0, 0) + 1]))

        # A'''[0, 0] = A''[0, 0] xor RC (flag-selected round constant)
        def xored_bit(i):
            rc_bit = a.zero
            for r in range(NUM_ROUNDS):
                rc_bit = a.add(rc_bit,
                               a.mul_const(flags[r], int(RC_BITS[r, i])))
            return _xor_gen(a, bits00[i], rc_bit)

        lo = a.zero
        hi = a.zero
        for z in reversed(range(32)):
            lo = a.add(a.mul_const(lo, 2), xored_bit(z))
        for z in reversed(range(32, 64)):
            hi = a.add(a.mul_const(hi, 2), xored_bit(z))
        consumer.constraint(
            a.sub(lo, lv[REG_A_PRIME_PRIME_PRIME_0_0_LO]))
        consumer.constraint(
            a.sub(hi, lv[REG_A_PRIME_PRIME_PRIME_0_0_HI]))

        # output of round r = input of round r+1 (within a permutation)
        not_last = a.sub(one, final_step)
        for x in range(5):
            for y in range(5):
                consumer.constraint_transition(a.mul(
                    not_last,
                    a.sub(lv[reg_a_prime_prime_prime(x, y)],
                          nv[reg_a(x, y)])))
                consumer.constraint_transition(a.mul(
                    not_last,
                    a.sub(lv[reg_a_prime_prime_prime(x, y) + 1],
                          nv[reg_a(x, y) + 1])))
