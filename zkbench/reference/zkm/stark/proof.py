# Frozen copy of zkm_tpu_torch/stark/proof.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""STARK proof containers (host-side numpy/int data).

Copy of zkm_tpu/stark/proof.py (zkMIPS prover/src/proof.rs: StarkProof{trace_cap,
auxiliary_polys_cap, quotient_polys_cap, openings, opening_proof},
StarkProofWithMetadata{init_challenger_state, proof}, AllProof{stark_proofs,
ctl_challenges, public_values}, PublicValues{roots_before, roots_after,
userdata}), plus `walk_proof`/`flatten_proof`, the reference's
`recursion.flatten_proof` walk of every public scalar of a proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..fri.proof import FriProof
from .cross_table_lookup import GrandProductChallengeSet


@dataclass
class MemRoots:
    """Pre/post state commitment: image id as 8 u32 words.

    The zkMIPS prover transmutes [u8;32] -> [u32;8] (generation/mod.rs),
    i.e. little-endian words of the image-id bytes."""
    root: List[int]  # 8 u32 values

    @staticmethod
    def from_image_id(image_id: bytes) -> "MemRoots":
        assert len(image_id) == 32
        return MemRoots([int.from_bytes(image_id[i:i + 4], "little")
                         for i in range(0, 32, 4)])

    def to_image_id(self) -> bytes:
        return b"".join(int(w).to_bytes(4, "little") for w in self.root)


@dataclass
class PublicValues:
    roots_before: MemRoots
    roots_after: MemRoots
    userdata: bytes  # 32 bytes: SHA256 of the public input


@dataclass
class StarkOpeningSet:
    local_values: np.ndarray          # (C, 2) u64 ext
    next_values: np.ndarray           # (C, 2)
    auxiliary_polys: np.ndarray       # (A, 2)
    auxiliary_polys_next: np.ndarray  # (A, 2)
    ctl_zs_first: np.ndarray          # (Z,) u64 base
    quotient_polys: np.ndarray        # (Q, 2)

    def fri_batches(self):
        """Values per FRI batch, matching stark fri_instance order."""
        zeta = np.concatenate([self.local_values, self.auxiliary_polys,
                               self.quotient_polys], axis=0)
        zeta_next = np.concatenate(
            [self.next_values, self.auxiliary_polys_next], axis=0)
        ctl_first = np.stack(
            [self.ctl_zs_first, np.zeros_like(self.ctl_zs_first)], axis=1)
        return [zeta, zeta_next, ctl_first]


@dataclass
class StarkProof:
    trace_cap: np.ndarray             # (2^cap, 4) u64
    auxiliary_polys_cap: np.ndarray
    quotient_polys_cap: np.ndarray
    openings: StarkOpeningSet
    opening_proof: FriProof


@dataclass
class StarkProofWithMetadata:
    init_challenger_state: List[int]  # 12 sponge elements
    proof: StarkProof
    degree_bits: int


@dataclass
class AllProof:
    stark_proofs: List[StarkProofWithMetadata]
    ctl_challenges: GrandProductChallengeSet
    public_values: PublicValues

    def degree_bits(self) -> List[int]:
        return [p.degree_bits for p in self.stark_proofs]


# frozen: left out, as only the prover uses them: WOpenings, WFriProof,
# WStarkProof, WAllProof, walk_proof, flatten_proof, flat_sha256.

