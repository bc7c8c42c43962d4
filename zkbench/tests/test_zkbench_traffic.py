"""Each mix's guests (every file of `traffic/`, also one that no cell
runs yet) keep their steps and segments across seeds (only
their data depends on the seed), and program i of a run is the same
for the same seed."""

import os

import pytest

from zkbench import generator
from zkbench.reference.check import emulate

MIXES = sorted(f[:-5] for f in os.listdir(generator.TRAFFIC_DIR)
               if f.endswith(".json"))
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


@pytest.mark.parametrize("mix", MIXES)
def test_steps_fixed_across_seeds(mix):
    tr = generator.load_traffic(mix)
    codes = set()
    for seed in SEEDS:
        p = generator.program(tr, seed, 1)
        segs = emulate(p.code, p.inputs, 1 << 16)
        assert len(segs) == tr["segments_per_program"]
        assert sum(s["step"] for s in segs) == tr["steps_per_program"]
        codes.add((p.code, p.inputs))
    # the seed changes the data (the hash mix: its hint input)
    assert len(codes) == len(SEEDS)


@pytest.mark.parametrize("mix", MIXES)
def test_programs_repeat_with_their_seed(mix):
    tr = generator.load_traffic(mix)
    a, b = generator.programs(tr, 99), generator.programs(tr, 99)
    assert a == b and len(a) == tr["max_programs"] + 1
    assert len({(p.code, p.inputs) for p in a}) == len(a)
    assert len({len(p.code) for p in a}) == 1
