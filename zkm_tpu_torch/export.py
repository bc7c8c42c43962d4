"""Proof export / import: the stage-R4 wrap interface (docs/recursion.md).

Copy of zkm_tpu/export.py: the same JSON, character for character (zkMIPS
analog: recursion/src/lib.rs:92-159
(`wrap_stark_bn254` writes public_values.json / block_public_inputs.json
for the external Go gnark Groth16 wrapper — the filesystem is the
interface there too, snarks.rs:7-18)).  This module serializes an
`AllProof` (a segment proof, a shrunk proof, or an aggregation-root
proof — they share one container) and its verifying key to a stable,
documented JSON layout so an external STARK→SNARK adapter (or another
verifier implementation) can consume it without importing this package.

Layout (versioned, all field elements as decimal strings to survive JSON
number precision):

  {"version": 1,
   "config": {"num_challenges", "rate_bits", "cap_height",
              "proof_of_work_bits", "num_query_rounds", "arity_bits",
              "final_poly_bits"},
   "public_values": {"roots_before": [8 u32], "roots_after": [8 u32],
                     "userdata": hex},
   "program_cap": [[4 str] x 2^cap] | null,   # verifying key (shrunk/agg)
   "stark_proofs": [per table:
     {"degree_bits": int,
      "init_challenger_state": [12 str],
      "trace_cap" / "auxiliary_polys_cap" / "quotient_polys_cap":
          [[4 str] x 2^cap],
      "openings": {"local_values" / "next_values" / "auxiliary_polys" /
                   "auxiliary_polys_next" / "quotient_polys": [[2 str]],
                   "ctl_zs_first": [str]},
      "opening_proof": {
          "commit_phase_merkle_caps": [[[4 str]]],
          "query_rounds": [
             {"initial": {"evals_per_oracle": [[str]],
                          "merkle_proofs": [[[4 str]]]},
              "steps": [{"evals": [[2 str]],
                         "merkle_proof": [[4 str]]}]}],
          "final_poly": [[2 str]],
          "pow_witness": str}}]}
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .fri.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                        FriQueryStep)
from .stark.config import StarkConfig
from .stark.cross_table_lookup import GrandProductChallengeSet
from .stark.proof import (AllProof, MemRoots, PublicValues, StarkOpeningSet,
                          StarkProof, StarkProofWithMetadata)

EXPORT_VERSION = 1


def _s(x) -> str:
    return str(int(x))


def _arr(a) -> list:
    """Nested lists of decimal strings from an int/array nest."""
    a = np.asarray(a)
    if a.ndim == 0:
        return _s(a)
    return [_arr(row) for row in a]


def _u64s(v) -> np.ndarray:
    """Decimal-string nest -> uint64 ndarray."""
    return np.asarray(_nest(v), dtype=np.uint64)


def _nest(v):
    if isinstance(v, list):
        return [_nest(x) for x in v]
    return int(v)


def export_proof(proof: AllProof, config: StarkConfig,
                 program_cap: Optional[np.ndarray] = None) -> dict:
    fc = config.fri_config
    pv = proof.public_values
    out = {
        "version": EXPORT_VERSION,
        "config": {
            "num_challenges": config.num_challenges,
            "rate_bits": fc.rate_bits,
            "cap_height": fc.cap_height,
            "proof_of_work_bits": fc.proof_of_work_bits,
            "num_query_rounds": fc.num_query_rounds,
            "arity_bits": fc.arity_bits,
            "final_poly_bits": fc.final_poly_bits,
        },
        "public_values": {
            "roots_before": [int(v) for v in pv.roots_before.root],
            "roots_after": [int(v) for v in pv.roots_after.root],
            "userdata": bytes(pv.userdata).hex(),
        },
        "program_cap": _arr(program_cap) if program_cap is not None else None,
        "stark_proofs": [],
    }
    for pm in proof.stark_proofs:
        pr = pm.proof
        op = pr.openings
        fp = pr.opening_proof
        rounds = []
        for rp in fp.query_round_proofs:
            rounds.append({
                "initial": {
                    "evals_per_oracle": [_arr(e) for e in
                                         rp.initial_trees_proof
                                         .evals_per_oracle],
                    "merkle_proofs": [[_arr(d) for d in sibs] for sibs in
                                      rp.initial_trees_proof.merkle_proofs],
                },
                "steps": [{"evals": _arr(st.evals),
                           "merkle_proof": [_arr(d)
                                            for d in st.merkle_proof]}
                          for st in rp.steps],
            })
        out["stark_proofs"].append({
            "degree_bits": pm.degree_bits,
            "init_challenger_state": [_s(v)
                                      for v in pm.init_challenger_state],
            "trace_cap": _arr(pr.trace_cap),
            "auxiliary_polys_cap": _arr(pr.auxiliary_polys_cap),
            "quotient_polys_cap": _arr(pr.quotient_polys_cap),
            "openings": {
                "local_values": _arr(op.local_values),
                "next_values": _arr(op.next_values),
                "auxiliary_polys": _arr(op.auxiliary_polys),
                "auxiliary_polys_next": _arr(op.auxiliary_polys_next),
                "ctl_zs_first": _arr(op.ctl_zs_first),
                "quotient_polys": _arr(op.quotient_polys),
            },
            "opening_proof": {
                "commit_phase_merkle_caps": [_arr(c) for c in
                                             fp.commit_phase_merkle_caps],
                "query_rounds": rounds,
                "final_poly": _arr(fp.final_poly),
                "pow_witness": _s(fp.pow_witness),
            },
        })
    return out


def import_proof(doc: dict) -> AllProof:
    if doc.get("version") != EXPORT_VERSION:
        raise ValueError(f"unsupported export version {doc.get('version')}")
    pv = doc["public_values"]
    public_values = PublicValues(
        roots_before=MemRoots([int(v) for v in pv["roots_before"]]),
        roots_after=MemRoots([int(v) for v in pv["roots_after"]]),
        userdata=bytes.fromhex(pv["userdata"]))
    proofs = []
    for tp in doc["stark_proofs"]:
        op = tp["openings"]
        fp = tp["opening_proof"]
        rounds = []
        for rp in fp["query_rounds"]:
            init = FriInitialTreeProof(
                evals_per_oracle=[_u64s(e)
                                  for e in rp["initial"]["evals_per_oracle"]],
                merkle_proofs=[[_u64s(d) for d in sibs]
                               for sibs in rp["initial"]["merkle_proofs"]])
            steps = [FriQueryStep(evals=_u64s(st["evals"]),
                                  merkle_proof=[_u64s(d)
                                                for d in st["merkle_proof"]])
                     for st in rp["steps"]]
            rounds.append(FriQueryRound(initial_trees_proof=init,
                                        steps=steps))
        proofs.append(StarkProofWithMetadata(
            init_challenger_state=[int(v)
                                   for v in tp["init_challenger_state"]],
            degree_bits=int(tp["degree_bits"]),
            proof=StarkProof(
                trace_cap=_u64s(tp["trace_cap"]),
                auxiliary_polys_cap=_u64s(tp["auxiliary_polys_cap"]),
                quotient_polys_cap=_u64s(tp["quotient_polys_cap"]),
                openings=StarkOpeningSet(
                    local_values=_u64s(op["local_values"]),
                    next_values=_u64s(op["next_values"]),
                    auxiliary_polys=_u64s(op["auxiliary_polys"]),
                    auxiliary_polys_next=_u64s(op["auxiliary_polys_next"]),
                    ctl_zs_first=_u64s(op["ctl_zs_first"]),
                    quotient_polys=_u64s(op["quotient_polys"])),
                opening_proof=FriProof(
                    commit_phase_merkle_caps=[
                        _u64s(c) for c in fp["commit_phase_merkle_caps"]],
                    query_round_proofs=rounds,
                    final_poly=_u64s(fp["final_poly"]),
                    pow_witness=int(fp["pow_witness"])))))
    return AllProof(stark_proofs=proofs,
                    ctl_challenges=GrandProductChallengeSet(challenges=[]),
                    public_values=public_values)


def export_proof_json(proof: AllProof, config: StarkConfig,
                      program_cap: Optional[np.ndarray] = None) -> str:
    return json.dumps(export_proof(proof, config, program_cap))


def import_proof_json(s: str) -> AllProof:
    return import_proof(json.loads(s))
