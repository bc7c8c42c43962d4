"""The work counts of the kernels' rooflines give their stated counts."""

import pytest

from zkbench import roofline


def test_poseidon_counts():
    # 8 full rounds: 48 multiplications, 290 additions each; the partial
    # rounds' pre-matrix 121 and 122; 22 partial rounds of 27 and 22, and
    # 21 round constants
    assert roofline.poseidon_field_ops() == (8 * 48 + 121 + 22 * 27,
                                             8 * 290 + 122 + 21 + 22 * 22)
    assert roofline.poseidon_field_ops() == (1099, 2947)
    assert roofline.poseidon_int32_ops() == 1099 * 16 + 2947 * 4 == 29372
    assert roofline.POSEIDON_BYTES == 192


@pytest.mark.parametrize("rows, n_in, log_n, want", [
    (1, 1 << 16, 16, (1 << 15) * 16),      # an intt: every stage
    (1, 1 << 16, 18, (1 << 17) * 16),      # an lde at rate 4: 2 copy stages
    (69, 1 << 16, 18, 69 * (1 << 17) * 16),
    (3, 5, 4, 3 * 8 * 3),                  # 5 values fill 8: 3 stages
    (2, 1, 4, 0),                          # a constant: copies only
])
def test_ntt_butterflies(rows, n_in, log_n, want):
    assert roofline.ntt_butterflies(rows, n_in, log_n) == want


def test_ntt_bytes_and_bound():
    assert roofline.ntt_bytes(2, 4, 3, False) == 8 * (8 + 16)
    assert roofline.ntt_bytes(2, 4, 3, True) == 8 * (8 + 16 + 4)
    assert roofline.BUTTERFLY_INT32_OPS == 24
    kind = "NVIDIA H100 80GB HBM3"
    peak = roofline.PEAKS[kind]
    assert peak["int32_ops_per_s"] == pytest.approx(1.672704e13)
    # compute-bound and memory-bound ends of the bound
    assert roofline.bound_s(1.672704e13, 0, kind) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12, kind) == pytest.approx(1.0)
    assert roofline.bound_s(1, 1, "a card without a stated peak") is None
