"""STARK proof containers (host-side numpy/int data).

Copy of zkm_tpu/stark/proof.py (zkMIPS prover/src/proof.rs: StarkProof{trace_cap,
auxiliary_polys_cap, quotient_polys_cap, openings, opening_proof},
StarkProofWithMetadata{init_challenger_state, proof}, AllProof{stark_proofs,
ctl_challenges, public_values}, PublicValues{roots_before, roots_after,
userdata}), plus `flatten_proof`, the reference's
`recursion.flatten_proof` walk of every public scalar of a proof.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np

from ..field.goldilocks import P
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


def flatten_proof(all_proof: AllProof) -> List[int]:
    """Every public scalar of the proof, in the order of the reference's
    `recursion/verifier_dag.py:_walk_proof` (so the sha256 of its
    little-endian u64 bytes equals the reference's digest)."""
    out: List[int] = []

    def put(v):
        out.append(int(v) % P)

    def cap(c):
        for row in np.asarray(c):
            for v in row:
                put(v)

    def exts(arr):
        for r in np.asarray(arr):
            put(r[0])
            put(r[1])

    pv = all_proof.public_values
    for v in list(pv.roots_before.root) + list(pv.roots_after.root) \
            + list(pv.userdata):
        put(v)
    for pm in all_proof.stark_proofs:
        pr, op, fp = pm.proof, pm.proof.openings, pm.proof.opening_proof
        for rp in fp.query_round_proofs:
            for e in rp.initial_trees_proof.evals_per_oracle:
                for v in np.asarray(e):
                    put(v)
            for sibs in rp.initial_trees_proof.merkle_proofs:
                for d in sibs:
                    for v in np.asarray(d):
                        put(v)
            for st in rp.steps:
                exts(st.evals)
                for d in st.merkle_proof:
                    for v in np.asarray(d):
                        put(v)
        for v in pm.init_challenger_state:
            put(v)
        cap(pr.trace_cap)
        cap(pr.auxiliary_polys_cap)
        cap(pr.quotient_polys_cap)
        exts(op.local_values)
        exts(op.next_values)
        exts(op.auxiliary_polys)
        exts(op.auxiliary_polys_next)
        for v in np.asarray(op.ctl_zs_first):
            put(v)
        exts(op.quotient_polys)
        for c in fp.commit_phase_merkle_caps:
            cap(c)
        exts(fp.final_poly)
        put(fp.pow_witness)
    return out


def flat_sha256(flat: List[int]) -> str:
    """sha256 of the flattened proof as little-endian u64 bytes."""
    return hashlib.sha256(
        b"".join(int(v).to_bytes(8, "little") for v in flat)).hexdigest()
