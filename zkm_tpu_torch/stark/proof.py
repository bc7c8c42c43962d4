"""STARK proof containers (host-side numpy/int data).

Copy of zkm_tpu/stark/proof.py (zkMIPS prover/src/proof.rs: StarkProof{trace_cap,
auxiliary_polys_cap, quotient_polys_cap, openings, opening_proof},
StarkProofWithMetadata{init_challenger_state, proof}, AllProof{stark_proofs,
ctl_challenges, public_values}, PublicValues{roots_before, roots_after,
userdata}), plus `walk_proof`/`flatten_proof`, the reference's
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


@dataclass
class WOpenings:
    """A table's openings mirrored by `walk_proof`'s leaves."""
    local_values: List            # C ext pairs
    next_values: List
    auxiliary_polys: List         # A ext pairs
    auxiliary_polys_next: List
    ctl_zs_first: List            # Z base leaves
    quotient_polys: List          # Q ext pairs


@dataclass
class WFriProof:
    commit_phase_merkle_caps: List       # per layer: [2^cap][4] leaves
    query_rounds: List                   # (evals_per_oracle, init_proofs,
    #                                       [(step evals, siblings)])
    final_poly: List                     # ext pairs
    pow_witness: object


@dataclass
class WStarkProof:
    init_challenger_state: List
    trace_cap: List
    auxiliary_polys_cap: List
    quotient_polys_cap: List
    openings: WOpenings
    opening_proof: WFriProof
    degree_bits: int


@dataclass
class WAllProof:
    stark_proofs: List
    roots_before: List    # 8 leaves
    roots_after: List     # 8 leaves
    userdata: List        # 32 leaves


def walk_proof(all_proof: AllProof, leaf) -> WAllProof:
    """Apply `leaf` to every public scalar of the proof in one fixed order
    (zkm_tpu/recursion/verifier_dag.py:_walk_proof's) and mirror the proof
    with the results.  `flatten_proof` collects the scalars; the recursive
    verifier (recursion/verifier_dag.py) makes each one a DAG input."""
    pv = all_proof.public_values
    roots_before = [leaf(v) for v in pv.roots_before.root]
    roots_after = [leaf(v) for v in pv.roots_after.root]
    userdata = [leaf(b) for b in pv.userdata]

    def cap(c):
        return [[leaf(v) for v in row] for row in np.asarray(c)]

    def exts(arr):
        return [(leaf(r[0]), leaf(r[1])) for r in np.asarray(arr)]

    tables = []
    for pm in all_proof.stark_proofs:
        pr = pm.proof
        op = pr.openings
        fp = pr.opening_proof
        rounds = []
        for rp in fp.query_round_proofs:
            evals_per_oracle = [[leaf(v) for v in np.asarray(e)]
                                for e in rp.initial_trees_proof.evals_per_oracle]
            init_proofs = [[[leaf(v) for v in np.asarray(d)] for d in sibs]
                           for sibs in rp.initial_trees_proof.merkle_proofs]
            steps = []
            for st in rp.steps:
                steps.append((exts(st.evals),
                              [[leaf(v) for v in np.asarray(d)]
                               for d in st.merkle_proof]))
            rounds.append((evals_per_oracle, init_proofs, steps))
        tables.append(WStarkProof(
            init_challenger_state=[leaf(v) for v in pm.init_challenger_state],
            trace_cap=cap(pr.trace_cap),
            auxiliary_polys_cap=cap(pr.auxiliary_polys_cap),
            quotient_polys_cap=cap(pr.quotient_polys_cap),
            openings=WOpenings(
                local_values=exts(op.local_values),
                next_values=exts(op.next_values),
                auxiliary_polys=exts(op.auxiliary_polys),
                auxiliary_polys_next=exts(op.auxiliary_polys_next),
                ctl_zs_first=[leaf(v) for v in np.asarray(op.ctl_zs_first)],
                quotient_polys=exts(op.quotient_polys)),
            opening_proof=WFriProof(
                commit_phase_merkle_caps=[cap(c)
                                          for c in fp.commit_phase_merkle_caps],
                query_rounds=rounds,
                final_poly=exts(fp.final_poly),
                pow_witness=leaf(fp.pow_witness)),
            degree_bits=pm.degree_bits))
    return WAllProof(tables, roots_before, roots_after, userdata)


def flatten_proof(all_proof: AllProof) -> List[int]:
    """Every public scalar of the proof in `walk_proof`'s order (so the
    sha256 of its little-endian u64 bytes equals the reference's digest,
    and it is the recursive verifier's public-input vector)."""
    out: List[int] = []
    walk_proof(all_proof, lambda v: out.append(int(v) % P))
    return out


def flat_sha256(flat: List[int]) -> str:
    """sha256 of the flattened proof as little-endian u64 bytes."""
    return hashlib.sha256(
        b"".join(int(v).to_bytes(8, "little") for v in flat)).hexdigest()
