# Frozen copy of zkm_tpu_torch/fri/oracle.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Batched polynomial openings -> FRI: the verifier's half.

Counterpart of `zkm_tpu/fri/oracle.py` (plonky2's `fri_combine_initial`).
frozen: `open_and_prove` and the device helpers are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..field import extension as gl2
from ..field import goldilocks as gl
from .config import FriConfig

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


def _alpha_powers_host(alpha: Ext, n: int) -> List[Ext]:
    out = [(1, 0)]
    for _ in range(n - 1):
        out.append(gl2.host_mul(out[-1], alpha))
    return out


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
