# Frozen copy of zkm_tpu_torch/tables/poseidon_sponge.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""PoseidonSponge table: pad10*1 byte sponge over memory-read words.

Copy of zkm_tpu/tables/poseidon_sponge.py (zkMIPS
prover/src/poseidon_sponge/poseidon_sponge_stark.rs and columns.rs).
One row per absorbed rate block (32 bytes / 8 u32 words); an operation is
[0+ full-input rows] followed by exactly one final row carrying the
pad10*1 padding; the digest of the final row's permutation is
the sponge output.

Deviations of zkm_tpu (and so of this copy) from zkMIPS:
  * The memory CTL is *word-level*: 8 looking entries per row (one per rate
    word), not 32 byte-level entries (poseidon_sponge_stark.rs:64-100).
    Identical binding — every absorbed word is read from memory at the
    sponge timestamp — at a quarter of the CTL helper cost.  Inputs must
    be word-aligned (asserted in the witness logger; all reference uses —
    page data and image ids — are).
  * `new_rate` is *constrained* to equal the little-endian recombination of
    `block_bytes` and the block bytes are range-checked to [0, 256) via an
    in-table logUp, so the LE (poseidon input) and BE (memory value) views
    cannot diverge.  The reference leaves both unconstrained.
  * Final-row padding bytes are pinned by constraint (pad10*1 pattern as a
    function of the is_final_input_len flags); the reference only pins them
    in witness generation.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..hash import poseidon as ps
from ..stark.columns import Column, Filter
from ..stark.lookup import Lookup
from ..stark.stark import Stark

SPONGE_RATE = ps.SPONGE_RATE          # 8 words
SPONGE_CAPACITY = ps.SPONGE_WIDTH - ps.SPONGE_RATE   # 4
SPONGE_WIDTH = ps.SPONGE_WIDTH       # 12
DIGEST = ps.DIGEST                    # 4
RATE_BYTES = ps.RATE_BYTES            # 32


def _rng(start, count):
    return range(start, start + count)


IS_FULL_INPUT_BLOCK = 0
CONTEXT = 1
SEGMENT = 2
VIRT = _rng(3, SPONGE_RATE)                       # 3..10
TIMESTAMP = VIRT.stop                             # 11
LEN = TIMESTAMP + 1
ALREADY_ABSORBED = LEN + 1                        # bytes absorbed before row
IS_FINAL_INPUT_LEN = _rng(ALREADY_ABSORBED + 1, RATE_BYTES)   # 14..45
ORIGINAL_RATE = _rng(IS_FINAL_INPUT_LEN.stop, SPONGE_RATE)    # 46..53
ORIGINAL_CAPACITY = _rng(ORIGINAL_RATE.stop, SPONGE_CAPACITY)  # 54..57
BLOCK_BYTES = _rng(ORIGINAL_CAPACITY.stop, RATE_BYTES)         # 58..89
NEW_RATE = _rng(BLOCK_BYTES.stop, SPONGE_RATE)                 # 90..97
PARTIAL_UPDATED = _rng(NEW_RATE.stop, SPONGE_WIDTH - DIGEST)   # 98..105
UPDATED_DIGEST = _rng(PARTIAL_UPDATED.stop, DIGEST)            # 106..109
RANGE_COUNTER = UPDATED_DIGEST.stop               # byte range table (0..255)
RC_FREQUENCIES = RANGE_COUNTER + 1
NUM_COLUMNS = RC_FREQUENCIES + 1                  # 112

MIN_ROWS = 256     # the byte range-check table needs 256 rows


# frozen: left out, as only the prover uses them: PoseidonSpongeOp,
# generate_rows, _sponge_states.


def pad_pattern(flen: int) -> np.ndarray:
    """pad10*1 bytes appended to a final block of flen data bytes."""
    pad = np.zeros(RATE_BYTES, dtype=np.uint64)
    if flen == RATE_BYTES - 1:
        pad[flen] = 0b10000001
    else:
        pad[flen] = 1
        pad[RATE_BYTES - 1] = 0b10000000
    return pad


# ---------------------------------------------------------------------------
# Trace generation.  Rows are built column-major in numpy; the permutation
# states come from `ps.chain_states` (one batched permute per block index
# and distinct block count: kernel K1 on the card).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# CTL column views.
# ---------------------------------------------------------------------------

def ctl_looked_data() -> List[Column]:
    """CPU <-> sponge: (ctx, seg, virt0, len, timestamp, digest[4])."""
    return Column.singles(
        [CONTEXT, SEGMENT, VIRT.start, LEN, TIMESTAMP]
        + list(UPDATED_DIGEST))


def ctl_looked_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(IS_FINAL_INPUT_LEN))


def ctl_looking_poseidon_inputs() -> List[Column]:
    cols = Column.singles(list(NEW_RATE) + list(ORIGINAL_CAPACITY))
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_looking_poseidon_outputs() -> List[Column]:
    cols = Column.singles(list(UPDATED_DIGEST) + list(PARTIAL_UPDATED))
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_looking_poseidon_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(
        [IS_FULL_INPUT_BLOCK] + list(IS_FINAL_INPUT_LEN)))


def ctl_looking_memory(w: int) -> List[Column]:
    """Word-level memory read of rate word w: value is the big-endian
    recombination of its bytes (the CPU/memory word convention)."""
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
# Constraints.
# ---------------------------------------------------------------------------

class PoseidonSpongeStark(Stark):
    num_columns = NUM_COLUMNS

    def lookups(self):
        return [Lookup(
            columns=tuple(Column.single(c) for c in BLOCK_BYTES),
            table_column=Column.single(RANGE_COUNTER),
            frequencies_column=Column.single(RC_FREQUENCIES),
            filter_columns=(None,) * RATE_BYTES)]

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
        after = [lv[c] for c in UPDATED_DIGEST] + \
                [lv[c] for c in PARTIAL_UPDATED]
        nxt_before = [nv[c] for c in ORIGINAL_RATE] + \
                     [nv[c] for c in ORIGINAL_CAPACITY]
        for cur, nxt in zip(after, nxt_before):
            consumer.constraint_transition(a.mul(full, a.sub(nxt, cur)))
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

        # new_rate = LE recombination of block bytes (reference leaves this
        # to convention; constrained here)
        for w in range(SPONGE_RATE):
            comb = a.zero
            for j in range(4):
                comb = a.add(comb, a.mul_const(
                    lv[BLOCK_BYTES.start + 4 * w + j], 1 << (8 * j)))
            consumer.constraint(a.sub(lv[NEW_RATE.start + w], comb))

        # final-row padding bytes pinned: with final length i, byte j >= i
        # must equal the pad10*1 pattern (reference pins only in witness gen)
        for j in range(RATE_BYTES):
            acc = a.zero
            for i in range(j + 1):
                pad = pad_pattern(i)
                acc = a.add(acc, a.mul(
                    finals[i],
                    a.add_const(lv[BLOCK_BYTES.start + j], -int(pad[j]))))
            consumer.constraint(acc)
