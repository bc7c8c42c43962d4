"""The yardstick of the kernels' rooflines: the work each function needs,
counted from its definition, and the card's peaks.

The counts do not depend on how a kernel is written: they are the field
operations the function itself needs, each converted to 32-bit integer
operations at a fixed cost, so a faster rewrite of a kernel raises its
share and never lowers the count.

Fixed costs, in 32-bit integer operations on the card's INT32 lanes:
  * a Goldilocks multiplication (p = 2^64 - 2^32 + 1): 16, the 64 x 64 ->
    128-bit product as four 32 x 32 -> 64-bit products (8) and its
    reduction mod p (8);
  * a Goldilocks addition or subtraction, or a product by a small
    constant accumulated into a wide sum: 4, a 64-bit add as two adds
    with carry and the conditional correction as two.

Peaks: NVIDIA's H100 SXM5 data sheet and the CUDA C++ Programming
Guide's arithmetic throughput table (compute capability 9.0: 64 32-bit
integer add/multiply-add results per clock per SM), at the boost clock of
1,980 MHz over 132 SMs; HBM3 at 3.35 TB/s.  They assume the card's full
700 W: the run reports its power limit beside each share.
"""

from __future__ import annotations

from typing import Optional

FIELD_MUL_INT32_OPS = 16
FIELD_ADD_INT32_OPS = 4

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int32_ops_per_s": 132 * 64 * 1980e6,
        "hbm_bytes_per_s": 3.35e12,
    },
}

# Poseidon over Goldilocks as zkm (plonky2) defines it: width 12, rate 8,
# 4 + 4 full rounds around 22 partial rounds, x^7 S-boxes, a circulant MDS
# matrix of small constants (plus one diagonal term).
POSEIDON_WIDTH = 12
POSEIDON_FULL_ROUNDS = 8
POSEIDON_PARTIAL_ROUNDS = 22
SBOX_MULS = 4                    # x^2, x^4, x^6 = x^4 x^2, x^7 = x^6 x


def poseidon_field_ops() -> tuple:
    """(multiplications, additions) of one width-12 permutation in its
    cheapest known form, plonky2's: full rounds add 12 constants, take 12
    S-boxes and the small-constant MDS (144 products and 132 additions,
    plus the diagonal's product and addition, all counted as additions);
    the partial rounds run as one constant layer (12 additions) and one
    dense 11 x 11 pre-matrix (121 multiplications, 110 additions), then per
    round one S-box, one constant (on 21 of the 22 rounds) and the sparse
    MDS (23 multiplications, 22 additions)."""
    w = POSEIDON_WIDTH
    full_muls = w * SBOX_MULS
    full_adds = w + w * w + w * (w - 1) + 2
    pre_muls, pre_adds = (w - 1) ** 2, w + (w - 1) * (w - 2)
    part_muls = SBOX_MULS + w + (w - 1)
    part_adds = (w - 1) + (w - 1)
    muls = (POSEIDON_FULL_ROUNDS * full_muls + pre_muls
            + POSEIDON_PARTIAL_ROUNDS * part_muls)
    adds = (POSEIDON_FULL_ROUNDS * full_adds + pre_adds
            + (POSEIDON_PARTIAL_ROUNDS - 1)
            + POSEIDON_PARTIAL_ROUNDS * part_adds)
    return muls, adds


def poseidon_int32_ops() -> int:
    muls, adds = poseidon_field_ops()
    return muls * FIELD_MUL_INT32_OPS + adds * FIELD_ADD_INT32_OPS


POSEIDON_BYTES = 2 * POSEIDON_WIDTH * 8    # a state read and written


def ntt_butterflies(rows: int, n_in: int, log_n: int) -> int:
    """Radix-2 butterflies of `rows` size-2^log_n transforms of n_in
    values zero-padded: n/2 per stage over the stages that do not only
    copy padding (an input of 2^k values takes log_n - k stages' copies
    of zeros first)."""
    n = 1 << log_n
    k = max(0, (n_in - 1).bit_length())
    return rows * (n // 2) * k


BUTTERFLY_INT32_OPS = FIELD_MUL_INT32_OPS + 2 * FIELD_ADD_INT32_OPS


def ntt_bytes(rows: int, n_in: int, log_n: int, scaled: bool) -> int:
    """The input read once, the output written once, the scale table."""
    return 8 * (rows * n_in + rows * (1 << log_n) + (n_in if scaled else 0))


def bound_s(int32_ops: float, nbytes: float, kind: str) -> Optional[float]:
    """The least time the card needs for the work: the larger of its
    operations over the INT32 peak and its bytes over HBM's; None for a
    card without a stated peak."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(int32_ops / peak["int32_ops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])
