"""zkm_tpu_torch commitments against zkm_tpu.commit.polynomial_batch:
coefficients, bit-reversed leaves, every tree level, the cap and the
opened rows and paths.  Equality is exact (tolerance zero)."""

import numpy as np
import pytest
import torch

from zkm_tpu.commit import polynomial_batch as rpb
from zkm_tpu.field import goldilocks as rgl
from zkm_tpu_torch.commit.polynomial_batch import PolynomialBatch
from zkm_tpu_torch.convert import from_u64, to_u64

P = rgl.P


def _assert_same_batch(mine, ref):
    assert np.array_equal(to_u64(mine.coeffs), rgl.to_u64(ref.coeffs))
    assert np.array_equal(to_u64(mine.leaves), rgl.to_u64(ref.leaves))
    assert len(mine.tree.levels) == len(ref.tree.levels)
    for a, b in zip(mine.tree.levels, ref.tree.levels):
        assert np.array_equal(to_u64(a), rgl.to_u64(b))
    assert np.array_equal(mine.cap_u64(), ref.cap_u64())


@pytest.mark.parametrize("shape,cap_height", [((69, 1 << 6), 4),
                                              ((3, 1 << 2), 4)])
def test_from_values_matches_reference(shape, cap_height):
    """(69, 2^6) at rate 2 and cap 4 is the Logic table's commit shape;
    (3, 2^2) at cap 4 is a cap-sized tree (16 leaves, empty paths)."""
    rng = np.random.default_rng(shape[0] + shape[1])
    x = rng.integers(0, P, size=shape, dtype=np.uint64)
    ref = rpb.from_values(rgl.from_u64(x), 2, cap_height)
    mine = PolynomialBatch.from_values(from_u64(x), 2, cap_height,
                                       device="cpu")
    _assert_same_batch(mine, ref)

    indices = rng.integers(0, mine.lde_size, size=9).tolist()
    rows, paths = mine.open_rows(indices)
    ref_rows, ref_paths = ref.open_rows(indices)
    assert np.array_equal(rows, ref_rows)
    assert len(paths) == len(ref_paths)
    for p, q in zip(paths, ref_paths):
        assert len(p) == len(q) == mine.tree.num_leaves.bit_length() - 1 \
            - cap_height
        for a, b in zip(p, q):
            assert np.array_equal(a, b)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    x = from_u64(np.ones((2, 8), dtype=np.uint64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolynomialBatch.from_values(x, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolynomialBatch.from_coeffs(x, 2, 1)
