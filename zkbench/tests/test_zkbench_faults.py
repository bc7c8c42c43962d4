"""A run driven end to end on the CPU at a small size (the tests' own
configuration and mix in `data/`), past the harness's look for a card,
with the timed path broken underneath: `correct` has to come out false
for each fault a cell of this benchmark can have, and true without one.

No cell exchanges anything between chips (each takes one card), so that
fault does not apply.  The port proves the mix's one program once
(about two minutes on the CPU); each fault is applied to copies of its
segments and receipts."""

import copy
import json
import os

import pytest

from zkbench import harness, system

DATA = os.path.join(os.path.dirname(__file__), "data")


def load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


CELL = {"workload": {"name": "tiny", "chips": 1},
        "config": load("tiny-config.json"), "traffic": load("tiny-fib.json"),
        "end_to_end": [{"name": "segment_proofs_per_min",
                        "unit": "proofs/min"},
                       {"name": "peak_device_gib", "unit": "GiB"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}


@pytest.fixture(scope="module")
def proved():
    """The port's prover on the CPU, each distinct program proved once."""
    prover = system.Prover(CELL["config"], "cpu")
    memo = {}

    def prove(prog, timer=None):
        key = (prog.code, prog.inputs)
        if key not in memo:
            memo[key] = prover.prove(prog, timer)
        return copy.deepcopy(memo[key])
    return prove


def state_unchanged(segs, receipts, prog):
    """The emulator's step hands back its state: post-image = pre-image."""
    for s in segs:
        s.image_id = s.pre_image_id
    for r in receipts:
        r.image_id = r.pre_image_id
    return segs, receipts


def half_left_out(segs, receipts, prog):
    """Every other program's receipts left out."""
    return segs, ([] if prog.index % 2 else receipts)


def answer_altered(segs, receipts, prog):
    """One opened value of each proof changed where it is produced."""
    for r in receipts:
        vals = r.proof.stark_proofs[0].proof.openings.local_values
        vals[0, 0] = (int(vals[0, 0]) + 1) % ((1 << 64) - (1 << 32) + 1)
    return segs, receipts


def run(prove, fault=None, seconds=1e9):
    def broken(prog, timer=None):
        segs, receipts = prove(prog, timer)
        return fault(segs, receipts, prog) if fault else (segs, receipts)
    return harness.run_cell(CELL, 2**31 + 5, seconds, False, device="cpu",
                            prove=broken)


def test_sound_run_is_correct(proved):
    r = run(proved)
    assert r["correct"] and r["attempted"] == 2 and r["failed"] == 0
    assert all(v["value"] == 0 for v in r["compared"].values())
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("fault, number", [
    (state_unchanged, "segments_mismatched"),
    (half_left_out, "chain_breaks"),
    (answer_altered, "proofs_rejected"),
])
def test_fault_is_not_correct(proved, fault, number):
    r = run(proved, fault)
    assert not r["correct"]
    assert r["compared"][number]["value"] > 0


def test_control_is_not_correct():
    """control.py at this size: the port under one FRI query round fewer
    than the configuration states; the reference rejects its proof."""
    from zkbench import control
    rows = control.readings(CELL, [2**31 + 5], ["num_query_rounds=3"], "cpu",
                            log=lambda m: None)
    assert rows[0]["proofs_rejected"] == 1
    assert rows[0]["programs_checked"] == 1
