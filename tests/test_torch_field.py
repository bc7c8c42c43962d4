"""zkm_tpu_torch field layer against zkm_tpu: Goldilocks ops, the quadratic
extension and every NTT.  Inputs come from numpy seeds; equality is exact
(tolerance zero: all values are integers mod p)."""

import itertools

import jax
import numpy as np
import pytest
import torch

from zkm_tpu.field import extension as rgl2
from zkm_tpu.field import goldilocks as rgl
from zkm_tpu.field import ntt as rntt
from zkm_tpu_torch.convert import from_u64, to_u64
from zkm_tpu_torch.field import extension as gl2
from zkm_tpu_torch.field import goldilocks as gl
from zkm_tpu_torch.field import ntt

P = gl.P
EDGES = [0, 1, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63]


def _operands(seed: int, n: int = 512):
    """Random canonical values plus every pair of edge values."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    ea, eb = np.meshgrid(np.array(EDGES, dtype=np.uint64),
                         np.array(EDGES, dtype=np.uint64))
    return np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()])


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_reference(name):
    a, b = _operands(1)
    want = rgl.to_u64(getattr(rgl, name)(rgl.from_u64(a), rgl.from_u64(b)))
    got = to_u64(getattr(gl, name)(from_u64(a), from_u64(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["neg", "square", "inverse"])
def test_unary_ops_match_reference(name):
    a, _ = _operands(2)
    want = rgl.to_u64(getattr(rgl, name)(rgl.from_u64(a)))
    got = to_u64(getattr(gl, name)(from_u64(a)))
    assert np.array_equal(got, want)


def test_pow_const_and_sums_match_reference():
    """pow_const and sum_axis against the reference (one jitted call),
    pow_const also against python ints; prefix sums against python ints."""
    a, _ = _operands(3)
    m = a[:512].reshape(8, 64)
    exps = (0, 7, 255, (1 << 40) + 12345)

    def ops(mod, x, mat):
        return ([mod.pow_const(x, e) for e in exps]
                + [mod.sum_axis(mat, axis) for axis in (0, 1, -1)])
    want = jax.jit(lambda x, mat: ops(rgl, x, mat))(rgl.from_u64(a),
                                                   rgl.from_u64(m))
    got = ops(gl, from_u64(a), from_u64(m))
    for g, w in zip(got, want):
        assert np.array_equal(to_u64(g), rgl.to_u64(w))
    assert [int(v) for v in to_u64(got[3])] == \
        [pow(int(v), exps[3], P) for v in a]
    want = [v % P for v in itertools.accumulate(int(v) for v in a)]
    assert [int(v) for v in to_u64(gl.cumsum(from_u64(a)))] == want


def test_host_helpers_match_reference():
    for k in (0, 1, 5, 16, 32):
        assert gl.primitive_root_of_unity(k) == rgl.primitive_root_of_unity(k)
    assert np.array_equal(gl.host_powers(12345, 300),
                          rgl.host_powers(12345, 300))
    assert gl.host_inv(7) == rgl.host_inv(7)
    assert gl.host_pow(3, 1 << 40) == rgl.host_pow(3, 1 << 40)


def test_extension_mul_and_inverse_match_reference():
    rng = np.random.default_rng(4)
    a0, a1, b0, b1 = (rng.integers(0, P, size=256, dtype=np.uint64)
                      for _ in range(4))
    ra = rgl2.from_u64_pair(a0, a1)
    rb = rgl2.from_u64_pair(b0, b1)
    ta, tb = (from_u64(a0), from_u64(a1)), (from_u64(b0), from_u64(b1))
    for got, want in ((gl2.mul(ta, tb), rgl2.mul(ra, rb)),
                      (gl2.inverse(ta), rgl2.inverse(ra))):
        assert np.array_equal(to_u64(got[0]), rgl.to_u64(want[0]))
        assert np.array_equal(to_u64(got[1]), rgl.to_u64(want[1]))
    x = (int(a0[0]), int(a1[0]))
    assert gl2.host_inv(x) == rgl2.host_inv(x)
    assert gl2.host_pow(x, 99) == rgl2.host_pow(x, 99)


def _all_transforms(mod, x):
    return (mod.ntt(x), mod.intt(x), mod.coset_ntt(x), mod.coset_intt(x),
            mod.lde(x, 2))


@pytest.mark.parametrize("log_n", [1, 10])
def test_ntt_transforms_match_reference(log_n):
    """ntt, intt, coset_ntt, coset_intt and lde (rate 2) on (3, 2^log_n);
    the reference's five run as one jitted call (op-by-op dispatch of its
    unrolled stages costs several times the compile).  Its compile takes
    seconds per size, so the sizes between are held against the direct
    evaluation below."""
    rng = np.random.default_rng(100 + log_n)
    x = rng.integers(0, P, size=(3, 1 << log_n), dtype=np.uint64)
    tx = from_u64(x)
    want = jax.jit(lambda v: _all_transforms(rntt, v))(rgl.from_u64(x))
    got = _all_transforms(ntt, tx)
    for g, w in zip(got, want):
        assert np.array_equal(to_u64(g), rgl.to_u64(w))


def _direct(x, log_m, root_log, inverse=False, shift=1, post=1):
    """y[i] = post^i * sum_j x[j] * shift^j * w^(i j), for i < 2^log_m and
    w the primitive 2^root_log-th root of unity (inverted if `inverse`):
    an O(M N) evaluation built from field ops already held against the
    reference, independent of the NTT's stages, tables and ordering."""
    n, m = x.shape[-1], 1 << log_m
    w = gl.primitive_root_of_unity(root_log)
    if inverse:
        w = gl.host_inv(w)
    order = 1 << root_log
    exps = (torch.arange(m)[:, None] * torch.arange(n)[None, :]) % order
    vander = gl.powers(w, order, x.device)[exps]                     # (M, N)
    scaled = gl.mul(x, gl.powers(shift, n, x.device))                # (R, N)
    y = torch.stack([gl.sum_axis(gl.mul(vander, row), -1) for row in scaled])
    return gl.mul(y, gl.powers(post, m, x.device))


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_transforms_match_direct_evaluation(log_n):
    """The five transforms on (3, 2^log_n) against `_direct`, plus the
    bit-reversal permutation against the reference's."""
    rng = np.random.default_rng(200 + log_n)
    tx = from_u64(rng.integers(0, P, size=(3, 1 << log_n), dtype=np.uint64))
    n, g = 1 << log_n, gl.GENERATOR
    n_inv, g_inv = gl.host_inv(n), gl.host_inv(g)
    want = (_direct(tx, log_n, log_n),
            gl.mul(_direct(tx, log_n, log_n, inverse=True), n_inv),
            _direct(tx, log_n, log_n, shift=g),
            gl.mul(_direct(tx, log_n, log_n, inverse=True, post=g_inv), n_inv),
            _direct(tx, log_n + 2, log_n + 2, shift=g))
    for got, w in zip(_all_transforms(ntt, tx), want):
        assert torch.equal(got, w)
    assert np.array_equal(ntt.bit_reverse_tensor(log_n, tx.device).numpy(),
                          rntt.bit_reverse_indices(log_n))
    assert gl.GENERATOR == rgl.GENERATOR


@pytest.mark.parametrize("log_n", range(25))
def test_ntt_plan_runs_each_stage_once_within_a_tile(log_n):
    """K2's passes cover stages 1..log_n once each, in order; a tile fits
    its shared memory; a transform is one pass up to 2^11, two up to 2^22
    (the main path's sizes) and three up to 2^24; a pass takes 2^log_cols
    columns only where the transform has them (chunks in the first pass,
    low positions in a later one), and at least 4 where it has that many."""
    passes = ntt.plan(log_n)
    stages = [s for first, n, _ in passes for s in range(first, first + n)]
    assert stages == list(range(1, log_n + 1))
    assert len(passes) == (1 if log_n <= 11 else 2 if log_n <= 22 else 3)
    for i, (first, n, log_cols) in enumerate(passes):
        assert 0 <= n <= ntt.MAX_STAGES and n + log_cols <= ntt.LOG_TILE
        has = log_n - n if i == 0 else first - 1
        assert min(2, has) <= log_cols <= min(ntt.LOG_COLS, has)
