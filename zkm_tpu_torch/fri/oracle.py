"""Batched polynomial openings -> FRI: the prove_openings / combine_initial pair.

Counterpart of `zkm_tpu/fri/oracle.py` (plonky2's
`PolynomialBatch::prove_openings` and `fri_combine_initial`).  The combined
FRI input polynomial is built in value space over the LDE domain: for each
opening batch (point z, polynomial set S)
    comp(x)   = sum_i alpha^i p_i(x)          (x over the bit-reversed LDE)
    quotient  = (comp(x) - comp(z)) / (x - z)  (batched field inverse)
and batches accumulate as final = final * alpha^{|S|} + quotient, the
reference's ReducingFactor shift discipline.

Over a tp group (`comm`) the openings are evaluated on each rank's
column shards and gathered (they are small), and the quotient is
pointwise over the rank's block of the bit-reversed LDE rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..commit.polynomial_batch import PolynomialBatch
from ..convert import to_u64
from ..field import extension as gl2
from ..field import goldilocks as gl
from ..field import ntt
from ..iop.challenger import Challenger
from ..utils.timing import step
from .config import FriConfig
from .proof import FriProof
from .prover import fri_prove

Ext = Tuple[int, int]


@dataclass(frozen=True)
class PolyRange:
    """A contiguous range of polynomials within one oracle."""
    oracle: int
    start: int
    stop: int

    @property
    def count(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class OpeningBatch:
    point: Ext
    ranges: Tuple[PolyRange, ...]

    @property
    def num_polys(self) -> int:
        return sum(r.count for r in self.ranges)


@lru_cache(maxsize=32)
def lde_points_bitrev(log_m: int, shift: int,
                      device: torch.device) -> torch.Tensor:
    """x_m = shift * w^{rev(m)} over the LDE domain, bit-reversed order."""
    pows = gl.powers(gl.primitive_root_of_unity(log_m), 1 << log_m, device)
    return gl.mul(pows.index_select(0, ntt.bit_reverse_tensor(log_m, device)),
                  shift)


def _alpha_powers_host(alpha: Ext, n: int) -> List[Ext]:
    out = [(1, 0)]
    for _ in range(n - 1):
        out.append(gl2.host_mul(out[-1], alpha))
    return out


def _ext_powers(z: Ext, n: int, device) -> gl2.Gf2:
    """[1, z, ..., z^(n-1)] by doubling (log n extension muls)."""
    p0 = torch.empty(n, dtype=torch.int64, device=device)
    p1 = torch.empty(n, dtype=torch.int64, device=device)
    p0[0], p1[0] = 1, 0
    k, stepz = 1, z
    while k < n:
        take = min(k, n - k)
        new = gl2.mul((p0[:take], p1[:take]), stepz)
        p0[k:k + take], p1[k:k + take] = new
        k += take
        stepz = gl2.host_mul(stepz, stepz)
    return p0, p1


def eval_columns(coeffs: torch.Tensor, z: Ext) -> gl2.Gf2:
    """Every row of coeffs (C, N) evaluated at the extension point z:
    (C,) extension values on the device."""
    zp = _ext_powers(z, coeffs.shape[-1], coeffs.device)
    return gl2.sum_axis(gl2.mul_base(zp, coeffs), -1)


def eval_columns_at_many(pairs, extra=(), comm=None, counts=None) -> list:
    """[(coeffs, z)] -> [(C, 2) u64 openings], then `extra` device values
    as u64 arrays, appended in order.  Over a tp group `comm`, coeffs and
    extra are this rank's column shards, counts[k] every rank's column
    count for pairs + extra in order; the values are gathered in one
    all_gather."""
    vals = [torch.stack(eval_columns(coeffs, z), -1) for coeffs, z in pairs]
    vals += [torch.stack([e, torch.zeros_like(e)], -1) for e in extra]
    if comm is not None:
        vals = comm.gather_cols(list(zip(vals, counts)))
    outs = [to_u64(v) for v in vals]
    return outs[:len(pairs)] + [o[:, 0].copy() for o in outs[len(pairs):]]


def _batch_quotient(ranges, oracle_leaves, alpha_pows: gl2.Gf2, cz: Ext,
                    z: Ext, xs: torch.Tensor) -> gl2.Gf2:
    """(sum_i alpha^i p_i(x) - comp(z)) / (x - z) over the LDE leaves."""
    acc = None
    i = 0
    for r in ranges:
        sub = oracle_leaves[r.oracle][:, r.start:r.stop]          # (M, k)
        a0 = alpha_pows[0][i:i + r.count]
        a1 = alpha_pows[1][i:i + r.count]
        term = (gl.sum_axis(gl.mul(sub, a0), -1),
                gl.sum_axis(gl.mul(sub, a1), -1))
        acc = term if acc is None else gl2.add(acc, term)
        i += r.count
    num = (gl.sub(acc[0], cz[0]), gl.sub(acc[1], cz[1]))
    den = (gl.sub(xs, z[0]), gl.full(xs.shape, (-z[1]) % gl.P, xs.device))
    return gl2.mul(num, gl2.inverse(den))


def open_and_prove(batches: Sequence[OpeningBatch],
                   openings_per_batch: Sequence[np.ndarray],
                   oracles: Sequence[PolynomialBatch],
                   challenger: Challenger,
                   config: FriConfig, timer=None, comm=None) -> FriProof:
    """openings_per_batch[b]: (num_polys, 2) u64 values p_i(z_b), already
    observed by the caller.  Over a tp group `comm`, the oracles' leaves
    are this rank's blocks."""
    degree_bits = oracles[0].degree_bits
    log_m = degree_bits + config.rate_bits
    device = oracles[0].leaves.device

    alpha = challenger.get_extension_challenge()

    with step(timer, "fri"):
        xs = lde_points_bitrev(log_m, gl.GENERATOR, device)
        if comm is not None:
            b = oracles[0].leaves.shape[0]
            xs = xs[comm.rank * b:(comm.rank + 1) * b]
        oracle_leaves = tuple(o.leaves for o in oracles)
        final = None
        for batch, opens in zip(batches, openings_per_batch):
            alpha_pows = _alpha_powers_host(alpha, max(1, batch.num_polys))
            ap = np.array(alpha_pows, dtype=np.uint64)
            ap_t = (gl.from_ints(ap[:, 0], device),
                    gl.from_ints(ap[:, 1], device))
            cz = (0, 0)
            for i in range(batch.num_polys):
                term = gl2.host_mul(alpha_pows[i],
                                    (int(opens[i][0]), int(opens[i][1])))
                cz = ((cz[0] + term[0]) % gl.P, (cz[1] + term[1]) % gl.P)
            quot = _batch_quotient(batch.ranges, oracle_leaves, ap_t, cz,
                                   batch.point, xs)
            if final is None:
                final = quot
            else:
                shift = gl2.host_pow(alpha, batch.num_polys)
                final = gl2.add(gl2.mul(final, shift), quot)

    return fri_prove(oracles, final, degree_bits, challenger, config, timer,
                     comm)


def make_combine_initial(batches: Sequence[OpeningBatch],
                         openings_per_batch: Sequence[np.ndarray],
                         alpha: Ext,
                         degree_bits: int,
                         config: FriConfig):
    """Verifier-side combine callback for verify_fri_proof (host ints)."""
    log_m = degree_bits + config.rate_bits
    w = gl.primitive_root_of_unity(log_m)

    def combine(x_index: int, evals_per_oracle: List[np.ndarray]) -> Ext:
        rev = int(bin(x_index)[2:].zfill(log_m)[::-1], 2) if log_m else 0
        x = (gl.GENERATOR * pow(w, rev, gl.P)) % gl.P
        acc: Ext = (0, 0)
        for batch, opens in zip(batches, openings_per_batch):
            alpha_pows = _alpha_powers_host(alpha, max(1, batch.num_polys))
            red: Ext = (0, 0)
            cz: Ext = (0, 0)
            i = 0
            for r in batch.ranges:
                for c in range(r.start, r.stop):
                    v = int(evals_per_oracle[r.oracle][c])
                    t = ((alpha_pows[i][0] * v) % gl.P,
                         (alpha_pows[i][1] * v) % gl.P)
                    red = ((red[0] + t[0]) % gl.P, (red[1] + t[1]) % gl.P)
                    o = gl2.host_mul(alpha_pows[i],
                                     (int(opens[i][0]), int(opens[i][1])))
                    cz = ((cz[0] + o[0]) % gl.P, (cz[1] + o[1]) % gl.P)
                    i += 1
            num = ((red[0] - cz[0]) % gl.P, (red[1] - cz[1]) % gl.P)
            den = ((x - batch.point[0]) % gl.P, (-batch.point[1]) % gl.P)
            quot = gl2.host_mul(num, gl2.host_inv(den))
            shift = gl2.host_pow(alpha, batch.num_polys)
            acc = gl2.host_mul(acc, shift)
            acc = ((acc[0] + quot[0]) % gl.P, (acc[1] + quot[1]) % gl.P)
        return acc

    return combine
