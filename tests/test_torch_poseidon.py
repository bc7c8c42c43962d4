"""zkm_tpu_torch Poseidon and challenger against zkm_tpu.

On the CPU the port's `permute` is the plain version of kernel K1, and the
reference's `permute_jit` is the path that
`pallas_poseidon.permute_batch(use_pallas=False)` runs: the function the
Pallas kernel computes.  Equality is exact (tolerance zero)."""

import json
import os

import numpy as np
import pytest

from zkm_tpu.field import goldilocks as rgl
from zkm_tpu.hash import poseidon as rps
from zkm_tpu.iop.challenger import Challenger as RefChallenger
from zkm_tpu.ops import pallas_poseidon
from zkm_tpu_torch.convert import from_u64, to_u64
from zkm_tpu_torch.hash import poseidon as ps
from zkm_tpu_torch.iop.challenger import Challenger

P = rgl.P
VEC_PATH = os.path.join(os.path.dirname(__file__), "data",
                        "golden_vectors.json")


@pytest.fixture(scope="module")
def vectors():
    with open(VEC_PATH) as f:
        return json.load(f)


def test_permute_matches_reference_on_1024_states():
    rng = np.random.default_rng(7)
    x = rng.integers(0, P, size=(1024, 12), dtype=np.uint64)
    x[0] = 0
    x[1] = P - 1
    want = rgl.to_u64(pallas_poseidon.permute_batch(rgl.from_u64(x),
                                                    use_pallas=False))
    assert np.array_equal(to_u64(ps.permute(from_u64(x))), want)


def test_permute_golden_vectors(vectors):
    for case in vectors["poseidon_permute"]:
        inp = np.array([int(v) for v in case["input"]], dtype=np.uint64)
        out = to_u64(ps.permute(from_u64(inp[None])))[0]
        assert [str(int(v)) for v in out] == case["output"]
        assert [str(v) for v in ps.permute_host(inp.tolist())] == \
            case["output"]


@pytest.mark.parametrize("width", [1, 4, 5, 8, 9, 69, 260])
def test_hash_or_noop_matches_reference(width):
    """Against the reference's host sponge at every width, and its device
    sponge up to two permutations (its op-by-op dispatch costs about a
    second per permutation here)."""
    rng = np.random.default_rng(width)
    x = rng.integers(0, P, size=(6, width), dtype=np.uint64)
    got = to_u64(ps.hash_or_noop(from_u64(x)))
    for row, digest in zip(x, got):
        assert [int(v) for v in digest] == rps.hash_or_noop_host(row.tolist())
    if width <= 2 * rps.SPONGE_RATE:
        want = rgl.to_u64(rps.hash_or_noop(rgl.from_u64(x)))
        assert np.array_equal(got, want)


def test_two_to_one_matches_reference():
    rng = np.random.default_rng(8)
    left = rng.integers(0, P, size=(32, 4), dtype=np.uint64)
    right = rng.integers(0, P, size=(32, 4), dtype=np.uint64)
    want = rgl.to_u64(rps.two_to_one(rgl.from_u64(left),
                                     rgl.from_u64(right)))
    got = to_u64(ps.two_to_one(from_u64(left), from_u64(right)))
    assert np.array_equal(got, want)
    assert ps.two_to_one_host(left[3].tolist(), right[3].tolist()) == \
        rps.two_to_one_host(left[3].tolist(), right[3].tolist())


def test_challenger_golden_vectors(vectors):
    v = vectors["challenger"]
    ch = Challenger()
    ch.observe_elements([1, 2, 3])
    assert [str(ch.get_challenge()) for _ in range(3)] == \
        v["after_observe_1_2_3"]
    ch.observe_cap([[5, 6, 7, 8], [9, 10, 11, 12]])
    assert [str(x) for x in ch.get_extension_challenge()] == \
        v["ext_after_cap"]
    assert [str(x) for x in ch.get_n_challenges(4)] == v["n_challenges"]
    assert [str(x) for x in ch.compact()] == v["compact_state"]


def test_challenger_matches_reference_transcript():
    rng = np.random.default_rng(9)
    mine, ref = Challenger(), RefChallenger()
    for step in range(20):
        vals = rng.integers(0, P, size=step % 11, dtype=np.uint64)
        mine.observe_elements(vals)
        ref.observe_elements(vals)
        assert mine.get_n_challenges(step % 5) == ref.get_n_challenges(step % 5)
    assert mine.compact() == ref.compact()
