# Frozen copy of zkm_tpu_torch/fri/proof.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""FRI proof containers (host-side, numpy-backed); copy of
zkm_tpu/fri/proof.py.

Layout notes vs the reference (plonky2 FriProof):
  * commit-phase Merkle leaves hold an arity-sized coset of extension values;
    this implementation lays a leaf out as [c0 x arity | c1 x arity]
    (plonky2 interleaves (c0, c1) pairs) — a serialization choice internal to
    this framework, flagged for future cross-verification work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class FriInitialTreeProof:
    """Openings of every oracle at one query index."""
    evals_per_oracle: List[np.ndarray]          # per oracle: (C_o,) u64
    merkle_proofs: List[List[np.ndarray]]       # per oracle: list of (4,) u64


@dataclass
class FriQueryStep:
    evals: np.ndarray                            # (arity, 2) u64 extension values
    merkle_proof: List[np.ndarray]               # list of (4,) u64 digests


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: List[np.ndarray]   # per round: (2^cap, 4) u64
    query_round_proofs: List[FriQueryRound]
    final_poly: np.ndarray                       # (deg, 2) u64 ext coefficients
    pow_witness: int
