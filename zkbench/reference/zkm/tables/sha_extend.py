# Frozen copy of zkm_tpu_torch/tables/sha_extend.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""ShaExtend table: one SHA-256 message-schedule step per row.

Copy of zkm_tpu/tables/sha_extend.py (zkMIPS prover/src/sha_extend/:
columns.rs, sha_extend_stark.rs, rotate_right.rs, shift_right.rs,
wrapping_add_4.rs).

zkm_tpu's redesign (and so this copy's): zkMIPS stores every
value as 4 unconstrained LE bytes, witnesses each rotation as a
(shift, carry) pair with no range checks, and outsources the four XORs to
the Logic table via CTLs.  Unranged (shift, carry) splits admit multiple
decompositions (rot' = rot ± (2^32-1) stays in-range), so we instead
*bit-slice*: w[i-15] and w[i-2] are stored as 32 boolean bits, making
every rotation/shift a static re-indexing and every XOR an in-table
degree-3 `xor3` — no rotation witnesses, no logic CTLs, unique
decompositions.  The 4-way wrapping add carries 2 boolean carry bits.

  s0 = (w15 >>> 7) ^ (w15 >>> 18) ^ (w15 >> 3)
  s1 = (w2 >>> 17) ^ (w2 >>> 19) ^ (w2 >> 10)
  w_i = (w16 + s0 + w2_s1_sum...) -- w_i = s1 + w16 + s0 + w7 mod 2^32
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..stark.columns import Column, Filter
from ..stark.stark import Stark


def _rng(start, count):
    return range(start, start + count)


W15_BITS = _rng(0, 32)
W2_BITS = _rng(32, 32)
W16 = 64
W7 = 65
WI_BITS = _rng(66, 32)
CARRY = _rng(98, 2)            # 2-bit carry of the 4-way wrapping add
TIMESTAMP = 100
IS_REAL = 101
NUM_COLUMNS = 102

M32 = 0xFFFFFFFF


@dataclass
class ShaExtendOp:
    """One SHA-256 message-schedule step, read by this table and by
    ShaExtendSponge; the witness type of zkm_tpu/witness/generation.py."""
    context: int
    segment: int
    virt_out: int
    timestamp: int
    inputs: List[int]            # w[i-15], w[i-2], w[i-16], w[i-7]
    output: int                  # w[i]


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


# frozen: left out, as only the prover uses them: extend_step,
# generate_rows.


def ctl_data_inputs() -> List[Column]:
    return [Column.le_bits(W15_BITS), Column.le_bits(W2_BITS),
            Column.single(W16), Column.single(W7),
            Column.single(TIMESTAMP)]


def ctl_data_outputs() -> List[Column]:
    return [Column.le_bits(WI_BITS), Column.single(TIMESTAMP)]


def ctl_filter() -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


def _xor_gen(a, x, y):
    return a.sub(a.add(x, y), a.mul_const(a.mul(x, y), 2))


def _xor3_gen(a, x, y, z):
    return _xor_gen(a, x, _xor_gen(a, y, z))


class ShaExtendStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one
        w15 = [lv[c] for c in W15_BITS]
        w2 = [lv[c] for c in W2_BITS]
        wi = [lv[c] for c in WI_BITS]
        carries = [lv[c] for c in CARRY]
        is_real = lv[IS_REAL]

        for b in w15 + w2 + wi + carries + [is_real]:
            consumer.constraint(a.mul(b, a.sub(b, one)))

        # s0/s1 bit z (static rotations; shifts drop high bits)
        def s0_bit(z):
            sh = w15[z + 3] if z < 29 else a.zero
            return _xor3_gen(a, w15[(z + 7) % 32], w15[(z + 18) % 32], sh)

        def s1_bit(z):
            sh = w2[z + 10] if z < 22 else a.zero
            return _xor3_gen(a, w2[(z + 17) % 32], w2[(z + 19) % 32], sh)

        s0 = a.zero
        s1 = a.zero
        wi_pack = a.zero
        for z in reversed(range(32)):
            s0 = a.add(a.mul_const(s0, 2), s0_bit(z))
            s1 = a.add(a.mul_const(s1, 2), s1_bit(z))
            wi_pack = a.add(a.mul_const(wi_pack, 2), wi[z])

        # w_i + carry*2^32 == s1 + w16 + s0 + w7  (wrapping_add_4).
        # Ungated: on all-zero padding rows both sides vanish, and gating
        # would push the xor3 terms past degree 3.
        total = a.add(a.add(s1, lv[W16]), a.add(s0, lv[W7]))
        carry = a.add(a.mul_const(carries[0], 1 << 32),
                      a.mul_const(carries[1], 1 << 33))
        consumer.constraint(a.sub(a.add(wi_pack, carry), total))
