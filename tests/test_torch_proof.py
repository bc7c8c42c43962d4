"""The whole slice on the CPU: zkm_tpu_torch proves Logic statements that
zkm_tpu's frozen vectors and its verifier accept.  Digests and caps are
compared exactly (tolerance zero)."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from zkm_tpu.fri import proof as rfri_proof
from zkm_tpu.recursion import flatten_proof as ref_flatten_proof
from zkm_tpu.stark import proof as rproof
from zkm_tpu.stark.config import StarkConfig as RefStarkConfig
from zkm_tpu.stark.cross_table_lookup import (
    CrossTableLookup as RefCrossTableLookup,
    GrandProductChallenge as RefChallenge,
    GrandProductChallengeSet as RefChallengeSet,
    TableWithColumns as RefTableWithColumns)
from zkm_tpu.stark.verifier import verify_proof as ref_verify_proof
from zkm_tpu.tables import logic as rlogic
from zkm_tpu_torch.convert import proof_to_plain, traces_from_rows
from zkm_tpu_torch.field.goldilocks import P
from zkm_tpu_torch.stark.config import StarkConfig
from zkm_tpu_torch.stark.cross_table_lookup import (CrossTableLookup,
                                                    TableWithColumns)
from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues, flat_sha256,
                                       flatten_proof)
from zkm_tpu_torch.stark.prover import prove_with_traces
from zkm_tpu_torch.stark.verifier import verify_proof
from zkm_tpu_torch.tables import logic

VEC_PATH = os.path.join(os.path.dirname(__file__), "data",
                        "golden_vectors.json")


def _self_ctls():
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    return [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]


def _ref_self_ctls():
    cols, filt = tuple(rlogic.ctl_data()), rlogic.ctl_filter()
    return [RefCrossTableLookup((RefTableWithColumns(0, cols, filt),),
                                RefTableWithColumns(0, cols, filt))]


def to_reference(plain) -> rproof.AllProof:
    """`proof_to_plain` output -> zkm_tpu's AllProof."""
    tables = []
    for t in plain["stark_proofs"]:
        p, fp = t["proof"], t["proof"]["opening_proof"]
        rounds = [rfri_proof.FriQueryRound(
            rfri_proof.FriInitialTreeProof(
                q["initial_trees_proof"]["evals_per_oracle"],
                q["initial_trees_proof"]["merkle_proofs"]),
            [rfri_proof.FriQueryStep(s["evals"], s["merkle_proof"])
             for s in q["steps"]]) for q in fp["query_round_proofs"]]
        fri = rfri_proof.FriProof(fp["commit_phase_merkle_caps"], rounds,
                                  fp["final_poly"], fp["pow_witness"])
        tables.append(rproof.StarkProofWithMetadata(
            t["init_challenger_state"],
            rproof.StarkProof(p["trace_cap"], p["auxiliary_polys_cap"],
                              p["quotient_polys_cap"],
                              rproof.StarkOpeningSet(**p["openings"]), fri),
            t["degree_bits"]))
    pv = plain["public_values"]
    return rproof.AllProof(
        tables, RefChallengeSet([RefChallenge(b, g)
                                 for b, g in plain["ctl_challenges"]]),
        rproof.PublicValues(rproof.MemRoots(pv["roots_before"]),
                            rproof.MemRoots(pv["roots_after"]),
                            pv["userdata"]))


def test_frozen_logic_proof_reproduces():
    with open(VEC_PATH) as f:
        v = json.load(f)["logic_proof"]
    assert v["config"] == "test_config"
    rows = logic.generate_rows([tuple(o) for o in v["ops"]], min_rows=16)
    pv = PublicValues(MemRoots.from_image_id(bytes([3] * 32)),
                      MemRoots.from_image_id(bytes([4] * 32)), bytes(32))
    proof = prove_with_traces([logic.LogicStark()],
                              StarkConfig.test_config(),
                              traces_from_rows([rows], "cpu"), _self_ctls(),
                              pv, device="cpu")
    cap = proof.stark_proofs[0].proof.trace_cap.astype(str)
    assert cap.tolist() == v["trace_cap"]
    assert str(proof.stark_proofs[0].proof.opening_proof.pow_witness) == \
        v["pow_witness"]
    flat = flatten_proof(proof)
    assert len(flat) == v["num_flat_elements"]
    assert flat_sha256(flat) == v["sha256_flat"]


@pytest.fixture(scope="module")
def fast_proof():
    """A 2^8-row Logic statement under standard_fast_config."""
    rng = np.random.default_rng(21)
    k = 250
    ops = np.stack([rng.integers(0, 4, k), rng.integers(0, 1 << 32, k),
                    rng.integers(0, 1 << 32, k)], axis=1)
    pv = PublicValues(MemRoots.from_image_id(bytes(range(32))),
                      MemRoots.from_image_id(bytes(range(32, 64))),
                      bytes(range(64, 96)))
    proof = prove_with_traces(
        [logic.LogicStark()], StarkConfig.standard_fast_config(),
        traces_from_rows([logic.generate_rows(ops, min_rows=256)], "cpu"),
        _self_ctls(), pv, device="cpu")
    assert proof.stark_proofs[0].degree_bits == 8
    return proof


def test_reference_verifier_accepts_port_proof(fast_proof):
    ref = to_reference(proof_to_plain(fast_proof))
    ref_verify_proof([rlogic.LogicStark()], ref, _ref_self_ctls(),
                     RefStarkConfig.standard_fast_config())
    assert ref_flatten_proof(ref) == flatten_proof(fast_proof)


def test_port_verifier_accepts_and_rejects(fast_proof):
    config = StarkConfig.standard_fast_config()
    verify_proof([logic.LogicStark()], fast_proof, _self_ctls(), config)

    bad = copy.deepcopy(fast_proof)
    vals = bad.stark_proofs[0].proof.openings.local_values
    vals[0, 0] = (int(vals[0, 0]) + 1) % P
    with pytest.raises(ValueError):
        verify_proof([logic.LogicStark()], bad, _self_ctls(), config)
    with pytest.raises(ValueError):
        ref_verify_proof([rlogic.LogicStark()],
                         to_reference(proof_to_plain(bad)), _ref_self_ctls(),
                         RefStarkConfig.standard_fast_config())


def test_prove_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    pv = PublicValues(MemRoots([0] * 8), MemRoots([0] * 8), bytes(32))
    traces = traces_from_rows([logic.generate_rows([], min_rows=16)], "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_with_traces([logic.LogicStark()], StarkConfig.test_config(),
                          traces, _self_ctls(), pv)
