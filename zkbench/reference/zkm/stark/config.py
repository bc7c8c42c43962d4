# Frozen copy of zkm_tpu_torch/stark/config.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""STARK configuration.

Copy of zkm_tpu/stark/config.py (zkMIPS prover/src/config.rs's
standard_fast_config:
90-bit conjectured security, 2 challenges, rate 2^2, cap 2^4, PoW 16 bits,
FRI arity 2^4 (final poly <= 2^5), 37 query rounds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri.config import FriConfig


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig(
            security_bits=100, num_challenges=2,
            fri_config=FriConfig(rate_bits=2, cap_height=4,
                                 proof_of_work_bits=16, num_query_rounds=37,
                                 arity_bits=4, final_poly_bits=5))

    @staticmethod
    def test_config() -> "StarkConfig":
        """Small config for fast unit tests (NOT sound)."""
        return StarkConfig(
            security_bits=1, num_challenges=2,
            fri_config=FriConfig(rate_bits=2, cap_height=2,
                                 proof_of_work_bits=4, num_query_rounds=4,
                                 arity_bits=2, final_poly_bits=3))
