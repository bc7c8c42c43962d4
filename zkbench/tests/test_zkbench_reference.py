"""The plain reference accepts a proof the port makes on the CPU at a
small size, and rejects a tampered one, one for other public values, and
the control: the same statement proved with fewer FRI query rounds than
the configuration states (`control.py` runs it at a cell's size on the
card)."""

import copy

import numpy as np
import pytest

from zkbench.reference import check
from zkbench.reference.zkm.convert import proof_to_plain
from zkbench.reference.zkm.field.goldilocks import P
from zkbench.reference.zkm.stark import all_stark as ref_all_stark

CFG = {"tables": ["Logic"],
       "stark_config": {"security_bits": 100, "num_challenges": 2,
                        "rate_bits": 2, "cap_height": 4,
                        "proof_of_work_bits": 16, "num_query_rounds": 37,
                        "arity_bits": 4, "final_poly_bits": 5}}
PRE, POST = bytes(range(32)), bytes(range(32, 64))
CLAIM = {"pre_image_id": PRE, "image_id": POST, "userdata": bytes(32)}


def prove(query_rounds: int):
    """A 2^8-row Logic table with its self-lookup, proved by the port on
    the CPU."""
    from zkm_tpu_torch.convert import traces_from_rows
    from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
    from zkm_tpu_torch.stark.proof import MemRoots, PublicValues
    from zkm_tpu_torch.stark.prover import prove_with_traces
    from zkm_tpu_torch.tables import logic
    from zkbench.control import weakened
    from zkbench.system import Prover
    cfg = weakened(dict(CFG, seg_size=1 << 16),
                   [f"num_query_rounds={query_rounds}"])
    config = Prover(cfg, "cpu").config
    rng = np.random.default_rng(3)
    k = 1 << 8
    ops = np.stack([rng.integers(0, 4, k), rng.integers(0, 1 << 32, k),
                    rng.integers(0, 1 << 32, k)], axis=1)
    system = make_all_stark([Table.Logic])
    pv = PublicValues(MemRoots.from_image_id(PRE),
                      MemRoots.from_image_id(POST), bytes(32))
    rows = logic.generate_rows(ops, min_rows=64)
    proof = prove_with_traces(system.starks, config,
                              traces_from_rows([rows], "cpu"), system.ctls,
                              pv, device="cpu")
    return proof_to_plain(proof)


@pytest.fixture(scope="module")
def sound():
    return prove(37)


@pytest.fixture(scope="module")
def judge():
    return check.Judge(dict(CFG, seg_size=1 << 16))


def test_accepts_the_ports_proof(sound, judge):
    assert check.verify_receipt(judge.all_stark, judge.config, sound,
                                CLAIM) is None


def test_rejects_a_tampered_opening(sound, judge):
    bad = copy.deepcopy(sound)
    vals = bad["stark_proofs"][0]["proof"]["openings"]["local_values"]
    vals[0, 0] = (int(vals[0, 0]) + 1) % P
    assert "ValueError" in check.verify_receipt(judge.all_stark,
                                                judge.config, bad, CLAIM)


def test_rejects_other_public_values(sound, judge):
    other = dict(CLAIM, image_id=bytes(32))
    assert check.verify_receipt(judge.all_stark, judge.config, sound,
                                other) is not None


def test_rejects_the_control(judge):
    """Fewer query rounds (the copied verifier alone would zip them and
    accept)."""
    weak = prove(28)
    why = check.verify_receipt(judge.all_stark, judge.config, weak, CLAIM)
    assert why is not None and "28 FRI query rounds" in why


def test_reference_system_is_the_frozen_one(judge):
    assert type(judge.all_stark) is ref_all_stark.AllStark
