# Frozen copy of zkm_tpu_torch/convert.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Carrying values between numpy u64 arrays, int64 tensors and plain data.

A Goldilocks element is a u64; the port carries its bit pattern in an
int64 tensor, so conversion is a `view` and copies nothing on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .field.goldilocks import P


def from_u64(x, device=None) -> torch.Tensor:
    """numpy/python u64 values -> canonical int64 tensor (CPU unless a
    device is given)."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64) % np.uint64(P))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> host numpy u64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


# frozen: left out, as only the prover uses them: traces_from_rows.


def proof_to_plain(all_proof) -> dict:
    """An `AllProof` as nested dicts, lists, python ints and numpy u64
    arrays, every array in the reference's field order."""
    def u64(a):
        return np.asarray(a, dtype=np.uint64).copy()

    def fri(fp):
        return {
            "commit_phase_merkle_caps": [u64(c) for c in
                                         fp.commit_phase_merkle_caps],
            "query_round_proofs": [{
                "initial_trees_proof": {
                    "evals_per_oracle": [u64(e) for e in
                                         qr.initial_trees_proof.evals_per_oracle],
                    "merkle_proofs": [[u64(s) for s in sibs] for sibs in
                                      qr.initial_trees_proof.merkle_proofs]},
                "steps": [{"evals": u64(st.evals),
                           "merkle_proof": [u64(s) for s in st.merkle_proof]}
                          for st in qr.steps]}
                for qr in fp.query_round_proofs],
            "final_poly": u64(fp.final_poly),
            "pow_witness": int(fp.pow_witness),
        }

    tables = []
    for pm in all_proof.stark_proofs:
        pr, op = pm.proof, pm.proof.openings
        tables.append({
            "init_challenger_state": [int(v) for v in
                                      pm.init_challenger_state],
            "degree_bits": int(pm.degree_bits),
            "proof": {
                "trace_cap": u64(pr.trace_cap),
                "auxiliary_polys_cap": u64(pr.auxiliary_polys_cap),
                "quotient_polys_cap": u64(pr.quotient_polys_cap),
                "openings": {k: u64(getattr(op, k)) for k in (
                    "local_values", "next_values", "auxiliary_polys",
                    "auxiliary_polys_next", "ctl_zs_first",
                    "quotient_polys")},
                "opening_proof": fri(pr.opening_proof),
            }})
    pv = all_proof.public_values
    return {
        "stark_proofs": tables,
        "ctl_challenges": [(int(c.beta), int(c.gamma))
                           for c in all_proof.ctl_challenges.challenges],
        "public_values": {"roots_before": [int(v) for v in
                                           pv.roots_before.root],
                          "roots_after": [int(v) for v in pv.roots_after.root],
                          "userdata": bytes(pv.userdata)},
    }


def proof_from_plain(plain: dict):
    """`proof_to_plain`'s dict (of this package's proof or of zkm_tpu's,
    frozen) -> the port's `AllProof`, its arrays numpy u64."""
    from .fri.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                            FriQueryStep)
    from .stark.cross_table_lookup import (GrandProductChallenge,
                                           GrandProductChallengeSet)
    from .stark.proof import (AllProof, MemRoots, PublicValues,
                              StarkOpeningSet, StarkProof,
                              StarkProofWithMetadata)

    def u64(a):
        return np.asarray(a, dtype=np.uint64).copy()

    def fri(fp):
        return FriProof(
            commit_phase_merkle_caps=[u64(c) for c in
                                      fp["commit_phase_merkle_caps"]],
            query_round_proofs=[FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(
                    evals_per_oracle=[u64(e) for e in q["initial_trees_proof"]
                                      ["evals_per_oracle"]],
                    merkle_proofs=[[u64(s) for s in sibs] for sibs in
                                   q["initial_trees_proof"]["merkle_proofs"]]),
                steps=[FriQueryStep(evals=u64(st["evals"]),
                                    merkle_proof=[u64(s) for s in
                                                  st["merkle_proof"]])
                       for st in q["steps"]])
                for q in fp["query_round_proofs"]],
            final_poly=u64(fp["final_poly"]),
            pow_witness=int(fp["pow_witness"]))

    tables = []
    for t in plain["stark_proofs"]:
        p = t["proof"]
        tables.append(StarkProofWithMetadata(
            init_challenger_state=[int(v) for v in t["init_challenger_state"]],
            proof=StarkProof(
                trace_cap=u64(p["trace_cap"]),
                auxiliary_polys_cap=u64(p["auxiliary_polys_cap"]),
                quotient_polys_cap=u64(p["quotient_polys_cap"]),
                openings=StarkOpeningSet(**{k: u64(v) for k, v in
                                            p["openings"].items()}),
                opening_proof=fri(p["opening_proof"])),
            degree_bits=int(t["degree_bits"])))
    pv = plain["public_values"]
    return AllProof(
        stark_proofs=tables,
        ctl_challenges=GrandProductChallengeSet(
            [GrandProductChallenge(int(b), int(g))
             for b, g in plain["ctl_challenges"]]),
        public_values=PublicValues(
            roots_before=MemRoots([int(v) for v in pv["roots_before"]]),
            roots_after=MemRoots([int(v) for v in pv["roots_after"]]),
            userdata=bytes(pv["userdata"])))
