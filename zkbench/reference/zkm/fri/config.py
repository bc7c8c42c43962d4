# Frozen copy of zkm_tpu_torch/fri/config.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""FRI configuration, mirroring the reference's StarkConfig FRI parameters.

Copy of zkm_tpu/fri/config.py (zkMIPS prover/src/config.rs: rate_bits=2,
cap_height=4, proof_of_work_bits=16, ConstantArityBits(4, 5), 37 query
rounds, ~90-bit conjectured security).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 2
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 37
    arity_bits: int = 4
    final_poly_bits: int = 5

    def reduction_arity_bits(self, degree_bits: int) -> List[int]:
        """ConstantArityBits schedule: fold by 2^arity_bits while the degree
        stays above final_poly_bits and the folded LDE still covers the cap."""
        out = []
        d = degree_bits
        while (d > self.final_poly_bits
               and d + self.rate_bits - self.arity_bits >= self.cap_height):
            assert d >= self.arity_bits
            out.append(self.arity_bits)
            d -= self.arity_bits
        return out
