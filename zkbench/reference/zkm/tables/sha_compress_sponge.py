# Frozen copy of zkm_tpu_torch/tables/sha_compress_sponge.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""ShaCompressSponge table: one row per SHA-256 compress block.

Copy of zkm_tpu/tables/sha_compress_sponge.py (zkMIPS
prover/src/sha_compress_sponge/).  Binds the
initial state hx[8] to memory reads, the 64-round chain to the ShaCompress
table (input/output CTLs keyed by timestamp), computes the final wrapping
add out[i] = hx[i] + final[i] mod 2^32 in-table, and exposes the digest to
the CPU's sponge row.

Deviations of zkm_tpu (and so of this copy) from zkMIPS:
  * Word-level memory CTLs (zkMIPS reads hx byte-wise).
  * 8 extra memory CTLs *read back* the digest written by the CPU's
    GP-channel write row at timestamp+19 (after the write row's channel
    timestamps, before the next CPU row), binding the written words to
    the proven digest.
"""

from __future__ import annotations

from typing import List

from ..stark.columns import Column, Filter
from ..stark.stark import Stark


def _rng(start, count):
    return range(start, start + count)


CONTEXT = 0
SEGMENT = 1
H_VIRT = 2
W_VIRT_BASE = 3
TIMESTAMP = 4
HX = _rng(5, 8)                 # initial state words
FINAL = _rng(13, 8)             # state after 64 rounds
OUT = _rng(21, 8)               # digest: hx + final mod 2^32
CARRY = _rng(29, 8)             # carry bit per output add
IS_REAL = 37
NUM_COLUMNS = 38

M32 = 0xFFFFFFFF

# the digest read-back happens after the CPU write row (timestamps
# ts+10..ts+17); +19 stays below the next CPU row's channel range
OUT_TS_OFFSET = 19


# frozen: left out, as only the prover uses them: generate_rows.


def ctl_looked_data() -> List[Column]:
    """CPU sponge row: (ctx, seg, h_virt, ts, digest[8])."""
    return Column.singles(
        [CONTEXT, SEGMENT, H_VIRT, TIMESTAMP] + list(OUT))


def ctl_looked_filter() -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


def ctl_looking_compress_inputs() -> List[Column]:
    """Round-0 row of the compress chain: full initial state +
    addressing."""
    return Column.singles(list(HX)) + [
        Column.single(CONTEXT), Column.single(SEGMENT),
        Column.single(W_VIRT_BASE), Column.single(TIMESTAMP)]


def ctl_looking_compress_outputs() -> List[Column]:
    return Column.singles(list(FINAL)) + [
        Column.single(CONTEXT), Column.single(SEGMENT),
        Column.single(TIMESTAMP)]


def ctl_looking_compress_filter() -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


def ctl_looking_memory(i: int) -> List[Column]:
    """i in 0..7: hx word read at h_virt + 4i (timestamp ts);
    i in 8..15: digest read-back at h_virt + 4(i-8) (ts + 19)."""
    j = i % 8
    addr = Column.linear_combination_with_constant([(H_VIRT, 1)], 4 * j)
    if i < 8:
        value = Column.single(HX.start + j)
        ts = Column.single(TIMESTAMP)
    else:
        value = Column.single(OUT.start + j)
        ts = Column.linear_combination_with_constant(
            [(TIMESTAMP, 1)], OUT_TS_OFFSET)
    return [Column.one(), Column.single(CONTEXT), Column.single(SEGMENT),
            addr, value, ts]


NUM_MEMORY_CTLS = 16


def ctl_looking_memory_filter(i: int) -> Filter:
    return Filter.new_simple(Column.single(IS_REAL))


class ShaCompressSpongeStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one
        is_real = lv[IS_REAL]
        consumer.constraint(a.mul(is_real, a.sub(is_real, one)))
        for i in range(8):
            carry = lv[CARRY.start + i]
            consumer.constraint(a.mul(carry, a.sub(carry, one)))
            # out + carry*2^32 == hx + final
            consumer.constraint(a.sub(
                a.add(lv[OUT.start + i], a.mul_const(carry, 1 << 32)),
                a.add(lv[HX.start + i], lv[FINAL.start + i])))
