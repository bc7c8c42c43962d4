"""On the card: one run of a cell through `zkbench/run.py` as the check
runs it, its result line read as the check reads it."""

import json
import subprocess
import sys

import pytest

from zkbench import harness


@pytest.mark.card
def test_run_prints_a_correct_result_line(card):
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload",
         "full-2p16.memalloc", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"segment_proofs_per_min", "peak_device_gib",
                                 "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["kind"] == card
    assert list(r)[-1] == "compared"
    assert out.stderr.strip().splitlines()[-1].startswith("chain_breaks")
