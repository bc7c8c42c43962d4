# Frozen copy of zkm_tpu_torch/tables/sha_compress.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""ShaCompress table: one SHA-256 compression round per row, 65 rows per
block (64 round rows + 1 output row carrying the post-loop state).

Copy of zkm_tpu/tables/sha_compress.py (zkMIPS prover/src/sha_compress/:
columns.rs, sha_compress_stark.rs, not_operation.rs, wrapping_add_*.rs).

zkm_tpu's redesign (as tables/sha_extend.py): the working state halves
a,b,c and e,f,g are stored as 32 boolean bits each, so every rotation is
static re-indexing and Σ0/Σ1/ch/maj evaluate in-table:

    ch_z  = e f + (1-e) g            (the two products are disjoint)
    maj_z = ab + ac + bc - 2abc
    Σ1_z  = xor3(e[z+6], e[z+11], e[z+25])   (indices mod 32)
    Σ0_z  = xor3(a[z+2], a[z+13], a[z+22])

replacing zkMIPS's *12 logic-table CTLs per round* and its
unranged rotation witnesses.  Σ/ch/maj are materialized as packed value
columns (S1_VAL...) so the state-update transitions stay degree <= 3.
The round constant is selected by 65 one-hot round flags (64 rounds + the
output row), constrained like the Keccak round flags.

State update (row r -> r+1):
    temp1 = h + Σ1 + ch + K[r] + w          (values)
    e'    = d + temp1            mod 2^32   (carry_e, 3 bits)
    a'    = temp1 + Σ0 + maj     mod 2^32   (carry_a, 3 bits)
    b' c' f' g' = a b e f (bit copies), d' = c, h' = g (packed)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..stark.columns import Column, Filter
from ..stark.stark import Stark

NUM_ROUNDS = 64
NUM_FLAGS = NUM_ROUNDS + 1      # + output row

SHA_COMPRESS_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

M32 = 0xFFFFFFFF


def _rng(start, count):
    return range(start, start + count)


ROUND = _rng(0, NUM_FLAGS)                        # 0..64
A_BITS = _rng(ROUND.stop, 32)                     # 65..96
B_BITS = _rng(A_BITS.stop, 32)
C_BITS = _rng(B_BITS.stop, 32)
E_BITS = _rng(C_BITS.stop, 32)
F_BITS = _rng(E_BITS.stop, 32)
G_BITS = _rng(F_BITS.stop, 32)
D_VAL = G_BITS.stop
H_VAL = D_VAL + 1
W_VAL = H_VAL + 1
S0_VAL = W_VAL + 1
S1_VAL = S0_VAL + 1
CH_VAL = S1_VAL + 1
MAJ_VAL = CH_VAL + 1
CARRY_E = _rng(MAJ_VAL + 1, 3)
CARRY_A = _rng(CARRY_E.stop, 3)
CONTEXT = CARRY_A.stop
SEGMENT = CONTEXT + 1
W_VIRT = SEGMENT + 1
TIMESTAMP = W_VIRT + 1
NUM_COLUMNS = TIMESTAMP + 1                       # 274


@dataclass
class ShaCompressOp:
    """One SHA-256 compress block, read by this table and by
    ShaCompressSponge; the witness type of zkm_tpu/witness/generation.py."""
    context: int
    segment: int
    h_virt: int
    w_virt_base: int
    timestamp: int
    hx: List[int]                # initial state (8)
    w: List[int]                 # 64 schedule words
    final: List[int]             # state after 64 rounds


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


# frozen: left out, as only the prover uses them: compress_round,
# generate_rows.


def _pack(bits_range) -> Column:
    return Column.le_bits(bits_range)


def ctl_data_inputs() -> List[Column]:
    """Round-0 row: full initial state + addressing (looked by the
    compress sponge)."""
    return [_pack(A_BITS), _pack(B_BITS), _pack(C_BITS),
            Column.single(D_VAL), _pack(E_BITS), _pack(F_BITS),
            _pack(G_BITS), Column.single(H_VAL),
            Column.single(CONTEXT), Column.single(SEGMENT),
            Column.single(W_VIRT), Column.single(TIMESTAMP)]


def ctl_data_outputs() -> List[Column]:
    """Output row (flag 64): the post-loop state."""
    return [_pack(A_BITS), _pack(B_BITS), _pack(C_BITS),
            Column.single(D_VAL), _pack(E_BITS), _pack(F_BITS),
            _pack(G_BITS), Column.single(H_VAL),
            Column.single(CONTEXT), Column.single(SEGMENT),
            Column.single(TIMESTAMP)]


def ctl_filter_inputs() -> Filter:
    return Filter.new_simple(Column.single(ROUND.start))


def ctl_filter_outputs() -> Filter:
    return Filter.new_simple(Column.single(ROUND.start + NUM_ROUNDS))


def ctl_looking_memory() -> List[Column]:
    """One w-word read per round row."""
    return [Column.one(), Column.single(CONTEXT), Column.single(SEGMENT),
            Column.single(W_VIRT), Column.single(W_VAL),
            Column.single(TIMESTAMP)]


def ctl_looking_memory_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(
        range(ROUND.start, ROUND.start + NUM_ROUNDS)))


def _xor_gen(a, x, y):
    return a.sub(a.add(x, y), a.mul_const(a.mul(x, y), 2))


def _xor3_gen(a, x, y, z):
    return _xor_gen(a, x, _xor_gen(a, y, z))


class ShaCompressStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one
        flags = [lv[c] for c in ROUND]
        nflags = [nv[c] for c in ROUND]
        any_flag = flags[0]
        for f in flags[1:]:
            any_flag = a.add(any_flag, f)
        next_any = nflags[0]
        for f in nflags[1:]:
            next_any = a.add(next_any, f)

        # round flags: boolean, one-hot(-or-zero), gated first row,
        # 65-cyclic rotation, padding terminal (see tables/keccak.py)
        for f in flags:
            consumer.constraint(a.mul(f, a.sub(f, one)))
        consumer.constraint(a.mul(any_flag, a.sub(any_flag, one)))
        consumer.constraint_first_row(
            a.mul(any_flag, a.sub(flags[0], one)))
        for i in range(1, NUM_FLAGS):
            consumer.constraint_first_row(lv[ROUND.start + i])
        for i in range(NUM_FLAGS):
            consumer.constraint_transition(a.mul(
                next_any, a.sub(nflags[(i + 1) % NUM_FLAGS], flags[i])))
        consumer.constraint_transition(
            a.mul(next_any, a.sub(any_flag, one)))

        abits = [lv[c] for c in A_BITS]
        bbits = [lv[c] for c in B_BITS]
        cbits = [lv[c] for c in C_BITS]
        ebits = [lv[c] for c in E_BITS]
        fbits = [lv[c] for c in F_BITS]
        gbits = [lv[c] for c in G_BITS]
        for bit in abits + bbits + cbits + ebits + fbits + gbits:
            consumer.constraint(a.mul(bit, a.sub(bit, one)))
        for c in list(CARRY_E) + list(CARRY_A):
            consumer.constraint(a.mul(lv[c], a.sub(lv[c], one)))

        # Σ1 / ch / Σ0 / maj value columns (ungated, vanish on padding)
        s1 = a.zero
        ch = a.zero
        s0 = a.zero
        maj = a.zero
        for z in reversed(range(32)):
            s1_bit = _xor3_gen(a, ebits[(z + 6) % 32],
                               ebits[(z + 11) % 32], ebits[(z + 25) % 32])
            ch_bit = a.add(a.mul(ebits[z], fbits[z]),
                           a.mul(a.sub(one, ebits[z]), gbits[z]))
            s0_bit = _xor3_gen(a, abits[(z + 2) % 32],
                               abits[(z + 13) % 32], abits[(z + 22) % 32])
            ab = a.mul(abits[z], bbits[z])
            maj_bit = a.sub(
                a.add(ab, a.add(a.mul(abits[z], cbits[z]),
                                a.mul(bbits[z], cbits[z]))),
                a.mul_const(a.mul(ab, cbits[z]), 2))
            s1 = a.add(a.mul_const(s1, 2), s1_bit)
            ch = a.add(a.mul_const(ch, 2), ch_bit)
            s0 = a.add(a.mul_const(s0, 2), s0_bit)
            maj = a.add(a.mul_const(maj, 2), maj_bit)
        consumer.constraint(a.sub(lv[S1_VAL], s1))
        consumer.constraint(a.sub(lv[CH_VAL], ch))
        consumer.constraint(a.sub(lv[S0_VAL], s0))
        consumer.constraint(a.sub(lv[MAJ_VAL], maj))

        # state update transitions, gated on "current row is a round row"
        is_round = flags[0]
        for f in flags[1:NUM_ROUNDS]:
            is_round = a.add(is_round, f)

        k_val = a.zero
        for i in range(NUM_ROUNDS):
            k_val = a.add(k_val, a.mul_const(flags[i], SHA_COMPRESS_K[i]))

        temp1 = a.add(a.add(lv[H_VAL], lv[S1_VAL]),
                      a.add(a.add(lv[CH_VAL], k_val), lv[W_VAL]))

        def pack(cols, rows):
            acc = a.zero
            for c in reversed(list(cols)):
                acc = a.add(a.mul_const(acc, 2), rows[c])
            return acc

        carry_e = a.zero
        carry_a = a.zero
        for j in reversed(range(3)):
            carry_e = a.add(a.mul_const(carry_e, 2), lv[CARRY_E.start + j])
            carry_a = a.add(a.mul_const(carry_a, 2), lv[CARRY_A.start + j])

        next_a = pack(A_BITS, nv)
        next_e = pack(E_BITS, nv)
        consumer.constraint_transition(a.mul(is_round, a.sub(
            a.add(next_e, a.mul_const(carry_e, 1 << 32)),
            a.add(lv[D_VAL], temp1))))
        consumer.constraint_transition(a.mul(is_round, a.sub(
            a.add(next_a, a.mul_const(carry_a, 1 << 32)),
            a.add(temp1, a.add(lv[S0_VAL], lv[MAJ_VAL])))))
        for z in range(32):
            consumer.constraint_transition(a.mul(
                is_round, a.sub(nv[B_BITS.start + z], abits[z])))
            consumer.constraint_transition(a.mul(
                is_round, a.sub(nv[C_BITS.start + z], bbits[z])))
            consumer.constraint_transition(a.mul(
                is_round, a.sub(nv[F_BITS.start + z], ebits[z])))
            consumer.constraint_transition(a.mul(
                is_round, a.sub(nv[G_BITS.start + z], fbits[z])))
        consumer.constraint_transition(a.mul(
            is_round, a.sub(nv[D_VAL], pack(C_BITS, lv))))
        consumer.constraint_transition(a.mul(
            is_round, a.sub(nv[H_VAL], pack(G_BITS, lv))))

        # block-constant columns
        for c in (CONTEXT, SEGMENT, TIMESTAMP):
            consumer.constraint_transition(a.mul(
                is_round, a.sub(nv[c], lv[c])))
        # w address advances by 4 between round rows (not into the output
        # row, whose W_VIRT is unused)
        is_round_nonlast = flags[0]
        for f in flags[1:NUM_ROUNDS - 1]:
            is_round_nonlast = a.add(is_round_nonlast, f)
        consumer.constraint_transition(a.mul(
            is_round_nonlast,
            a.sub(nv[W_VIRT], a.add_const(lv[W_VIRT], 4))))
