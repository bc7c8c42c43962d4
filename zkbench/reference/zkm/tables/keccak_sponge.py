# Frozen copy of zkm_tpu_torch/tables/keccak_sponge.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""KeccakSponge table: rate-136 byte sponge over memory-read words.

Copy of zkm_tpu/tables/keccak_sponge.py (zkMIPS prover/src/keccak_sponge/
{columns.rs,keccak_sponge_stark.rs}).  One row per absorbed 136-byte block; an operation
is [0+ full-input rows] + exactly one final (padded) row; the digest is
read from the final row's `updated_digest_state_bytes`.

The absorb XOR is outsourced to the Logic table: 34 word CTLs per active
row bind xored_rate[w] = original_rate[w] XOR le_bytes(block[4w..4w+4])
(keccak_sponge_stark.rs:132-165); the permutation itself is bound by
input/output CTLs into the Keccak table keyed by timestamp.

Deviations of zkm_tpu (and so of this copy) from zkMIPS, as in
tables/poseidon_sponge.py:
  * Memory CTL is word-level (34 reads/row, value = big-endian byte
    recombination) instead of byte-level (136 reads/row) — guest keccak
    inputs are pre-padded to u32 words (runtime/precompiles io.rs:115-151)
    so word alignment always holds (asserted in the witness logger).
  * `block_bytes` and `updated_digest_state_bytes` are range-checked to
    [0, 256) via an in-table logUp.  zkMIPS leaves digest bytes
    unconstrained (their LE combos are CTL-pinned, but byte decompositions
    would be non-unique without the range check, letting a prover fake the
    CPU-facing BE digest view).  Soundness-increasing.
  * Final-row padding bytes are pinned by constraint (pad10*1), not just
    witness generation.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..stark.columns import Column, Filter
from ..stark.lookup import Lookup
from ..stark.stark import Stark

RATE_BYTES = 136
RATE_U32S = 34
CAPACITY_U32S = 16
WIDTH_U32S = 50
DIGEST_BYTES = 32
DIGEST_U32S = 8
PARTIAL_U32S = WIDTH_U32S - DIGEST_U32S       # 42


def _rng(start, count):
    return range(start, start + count)


IS_FULL_INPUT_BLOCK = 0
CONTEXT = 1
SEGMENT = 2
VIRT = _rng(3, RATE_U32S)                                  # 3..36
TIMESTAMP = VIRT.stop                                      # 37
LEN = TIMESTAMP + 1
ALREADY_ABSORBED = LEN + 1
IS_FINAL_INPUT_LEN = _rng(ALREADY_ABSORBED + 1, RATE_BYTES)    # 40..175
ORIGINAL_RATE = _rng(IS_FINAL_INPUT_LEN.stop, RATE_U32S)       # 176..209
ORIGINAL_CAPACITY = _rng(ORIGINAL_RATE.stop, CAPACITY_U32S)    # 210..225
BLOCK_BYTES = _rng(ORIGINAL_CAPACITY.stop, RATE_BYTES)         # 226..361
XORED_RATE = _rng(BLOCK_BYTES.stop, RATE_U32S)                 # 362..395
PARTIAL_UPDATED = _rng(XORED_RATE.stop, PARTIAL_U32S)          # 396..437
UPDATED_DIGEST_BYTES = _rng(PARTIAL_UPDATED.stop, DIGEST_BYTES)  # 438..469
RANGE_COUNTER = UPDATED_DIGEST_BYTES.stop                  # 470
RC_FREQUENCIES = RANGE_COUNTER + 1
NUM_COLUMNS = RC_FREQUENCIES + 1                           # 472

MIN_ROWS = 256     # byte range-check table needs 256 rows


# frozen: left out, as only the prover uses them: KeccakSpongeOp,
# _u32s_to_lanes, _lanes_to_u32s, generate_rows.


def pad_pattern(flen: int) -> np.ndarray:
    """pad10*1 bytes appended after flen data bytes
    (keccak_sponge_stark.rs:334-341)."""
    pad = np.zeros(RATE_BYTES, dtype=np.uint64)
    if flen == RATE_BYTES - 1:
        pad[flen] = 0b10000001
    else:
        pad[flen] = 1
        pad[RATE_BYTES - 1] = 0b10000000
    return pad


# ---------------------------------------------------------------------------
# Trace generation.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# CTL column views.
# ---------------------------------------------------------------------------

def ctl_looked_data() -> List[Column]:
    """CPU <-> sponge: (ctx, seg, virt0, len, ts, digest u32s big-endian,
    most-significant first) — keccak_sponge_stark.rs:28-50."""
    cols = Column.singles([CONTEXT, SEGMENT, VIRT.start, LEN, TIMESTAMP])
    for i in reversed(range(8)):
        cols.append(Column.linear_combination(
            (UPDATED_DIGEST_BYTES.start + 4 * i + j, 1 << (24 - 8 * j))
            for j in range(4)))
    return cols


def ctl_looked_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(IS_FINAL_INPUT_LEN))


def ctl_looking_keccak_inputs() -> List[Column]:
    cols = Column.singles(list(XORED_RATE) + list(ORIGINAL_CAPACITY))
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_looking_keccak_outputs() -> List[Column]:
    cols = []
    for l in range(DIGEST_U32S):
        cols.append(Column.linear_combination(
            (UPDATED_DIGEST_BYTES.start + 4 * l + i, 1 << (8 * i))
            for i in range(4)))
    cols += Column.singles(PARTIAL_UPDATED)
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_looking_keccak_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(
        [IS_FULL_INPUT_BLOCK] + list(IS_FINAL_INPUT_LEN)))


def ctl_looking_logic(w: int) -> List[Column]:
    """The w'th absorb XOR: original_rate[w] ^ block_word[w] = xored[w]
    (keccak_sponge_stark.rs:132-165; opcode constant = is_xor)."""
    block_word = Column.linear_combination(
        (BLOCK_BYTES.start + 4 * w + j, 1 << (8 * j)) for j in range(4))
    return [Column.constant_col(0b100110 << 6),
            Column.single(ORIGINAL_RATE.start + w),
            block_word,
            Column.single(XORED_RATE.start + w)]


def ctl_looking_logic_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(
        [IS_FULL_INPUT_BLOCK] + list(IS_FINAL_INPUT_LEN)))


def ctl_looking_memory(w: int) -> List[Column]:
    """Word-level memory read of rate word w (big-endian byte order)."""
    value = Column.linear_combination(
        (BLOCK_BYTES.start + 4 * w + j, 1 << (8 * (3 - j)))
        for j in range(4))
    return [Column.one(),                  # is_read
            Column.single(CONTEXT), Column.single(SEGMENT),
            Column.single(VIRT.start + w), value,
            Column.single(TIMESTAMP)]


def ctl_looking_memory_filter(w: int) -> Filter:
    """Word w is read iff full block, or final length > 4w bytes."""
    cols = [IS_FULL_INPUT_BLOCK] + \
        list(IS_FINAL_INPUT_LEN)[4 * w + 1:]
    return Filter.new_simple(Column.sum_cols(cols))


# ---------------------------------------------------------------------------
# Constraints (keccak_sponge_stark.rs:456-567).
# ---------------------------------------------------------------------------

class KeccakSpongeStark(Stark):
    num_columns = NUM_COLUMNS

    def lookups(self):
        byte_cols = list(BLOCK_BYTES) + list(UPDATED_DIGEST_BYTES)
        return [Lookup(
            columns=tuple(Column.single(c) for c in byte_cols),
            table_column=Column.single(RANGE_COUNTER),
            frequencies_column=Column.single(RC_FREQUENCIES),
            filter_columns=(None,) * len(byte_cols))]

    def eval_generic(self, a, lv, nv, consumer):
        one = a.one

        # byte range counter: 0, +{0,1}, ends at 255
        rc, n_rc = lv[RANGE_COUNTER], nv[RANGE_COUNTER]
        delta = a.sub(n_rc, rc)
        consumer.constraint_first_row(rc)
        consumer.constraint_transition(a.mul(delta, a.sub(delta, one)))
        consumer.constraint_last_row(a.sub(rc, a.constant(255)))

        # flag booleanity; full and final mutually exclusive
        full = lv[IS_FULL_INPUT_BLOCK]
        consumer.constraint(a.mul(full, a.sub(full, one)))
        finals = [lv[c] for c in IS_FINAL_INPUT_LEN]
        for f in finals:
            consumer.constraint(a.mul(f, a.sub(f, one)))
        is_final = finals[0]
        for f in finals[1:]:
            is_final = a.add(is_final, f)
        consumer.constraint(a.mul(is_final, a.sub(is_final, one)))
        consumer.constraint(a.mul(is_final, full))

        # first row: fresh sponge
        consumer.constraint_first_row(lv[ALREADY_ABSORBED])
        for c in list(ORIGINAL_RATE) + list(ORIGINAL_CAPACITY):
            consumer.constraint_first_row(lv[c])

        # final block -> next row starts a fresh sponge
        consumer.constraint_transition(a.mul(is_final, nv[ALREADY_ABSORBED]))
        for c in list(ORIGINAL_RATE) + list(ORIGINAL_CAPACITY):
            consumer.constraint_transition(a.mul(is_final, nv[c]))

        # full block -> op continuity into the next row
        for c in (CONTEXT, SEGMENT, TIMESTAMP, LEN):
            consumer.constraint_transition(
                a.mul(full, a.sub(lv[c], nv[c])))

        # full block -> next "before" state is our "after" state:
        # digest u32s recombined from bytes, then partial limbs
        for l in range(DIGEST_U32S):
            after = a.zero
            for i in reversed(range(4)):
                after = a.add(a.mul_const(after, 1 << 8),
                              lv[UPDATED_DIGEST_BYTES.start + 4 * l + i])
            consumer.constraint_transition(a.mul(
                full, a.sub(nv[ORIGINAL_RATE.start + l], after)))
        for i in range(RATE_U32S - DIGEST_U32S):        # partial -> rate
            consumer.constraint_transition(a.mul(
                full, a.sub(nv[ORIGINAL_RATE.start + DIGEST_U32S + i],
                            lv[PARTIAL_UPDATED.start + i])))
        skip = RATE_U32S - DIGEST_U32S
        for i in range(CAPACITY_U32S):                  # partial -> capacity
            consumer.constraint_transition(a.mul(
                full, a.sub(nv[ORIGINAL_CAPACITY.start + i],
                            lv[PARTIAL_UPDATED.start + skip + i])))

        # full block -> absorbed counter advances by RATE_BYTES
        consumer.constraint_transition(a.mul(full, a.sub(
            a.add_const(lv[ALREADY_ABSORBED], RATE_BYTES),
            nv[ALREADY_ABSORBED])))

        # dummy rows only at the end
        is_dummy = a.sub(a.sub(one, full), is_final)
        next_active = nv[IS_FULL_INPUT_BLOCK]
        for c in IS_FINAL_INPUT_LEN:
            next_active = a.add(next_active, nv[c])
        consumer.constraint_transition(a.mul(is_dummy, next_active))

        # final length flag consistency: flag i => len - absorbed == i
        offset = a.sub(lv[LEN], lv[ALREADY_ABSORBED])
        for i, f in enumerate(finals):
            consumer.constraint(a.mul(f, a.add_const(offset, -i)))

        # final-row padding bytes pinned (pad10*1)
        for j in range(RATE_BYTES):
            acc = a.zero
            for i in range(j + 1):
                pad = pad_pattern(i)
                acc = a.add(acc, a.mul(
                    finals[i],
                    a.add_const(lv[BLOCK_BYTES.start + j], -int(pad[j]))))
            consumer.constraint(acc)
