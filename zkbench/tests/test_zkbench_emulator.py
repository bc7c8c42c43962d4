"""The reference's emulator, a frozen copy of the port's, held against a
record it did not make: `zkm_tpu_torch/data/native_segments_reference.json`,
the segments that zkm_tpu's own emulator cut from the same guests.  So the
copy is not its own only witness: a fault that the port and its copy share
shows here as a difference in steps, boundaries or image ids."""

import json
import os

import numpy as np
import pytest

from zkbench import harness
from zkbench.guests import builders
from zkbench.reference import check

RECORD = os.path.join(harness.ROOT, "zkm_tpu_torch", "data",
                      "native_segments_reference.json")

GUESTS = {
    "memalloc": lambda: (builders.build_memalloc_guest(64, 64), ()),
    "memalloc_2^14": lambda: (builders.build_memalloc_guest(64, 64), ()),
    "hash": lambda: (builders.build_hash_guest(), (
        builders.hash_guest_input(4000, np.random.default_rng(0)),)),
}


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)["cases"]


@pytest.mark.parametrize("case", sorted(GUESTS))
def test_reference_emulator_matches_zkm_tpus_record(record, case):
    want = record[case]
    code, inputs = GUESTS[case]()
    got = check.emulate(code, inputs, want["seg_size"])
    assert sum(s["step"] for s in got) == want["total_steps"]
    assert len(got) == len(want["segments"])
    for g, w in zip(got, want["segments"]):
        assert (g["step"], g["pc"], g["end_pc"]) == \
            (w["step"], w["pc"], w["end_pc"])
        assert g["pre_image_id"].hex() == w["pre_image_id"]
        assert g["image_id"].hex() == w["image_id"]
