#!/usr/bin/env python3
"""The control of `correct`: the port proving a cell's programs under a
weaker StarkConfig than the configuration states, judged by the
reference under the stated one.  The reference has to reject it.

    python3 zkbench/control.py --workload <cell> --seeds 11,12,13 \
        [--set num_query_rounds=28]

Fewer FRI query rounds is the step that would tempt a later change: it
cuts the openings and the FRI queries and weakens soundness.  For each
seed it proves the program the window would take first and prints the
numbers the reference compares, one JSON line per seed.  It runs on the
card (the tests run `readings` on the CPU).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def weakened(cfg: dict, settings) -> dict:
    out = copy.deepcopy(cfg)
    for s in settings:
        key, value = s.split("=")
        if key not in out["stark_config"]:
            raise KeyError(f"no StarkConfig setting {key}")
        out["stark_config"][key] = int(value)
    return out


def readings(cell: dict, seeds, settings, device=None, log=print) -> list:
    from zkbench import generator, harness, system
    from zkbench.reference.check import Judge
    judge = Judge(cell["config"])
    prover = system.Prover(weakened(cell["config"], settings), device)
    out = []
    for seed in seeds:
        prog = generator.program(cell["traffic"], seed, 1)
        window = harness.run_window(prover.prove, [prog], 0.0)
        done = harness.plain_outputs(window, [0])
        numbers = judge.judge(done, [0],
                              cell["traffic"].get("segments_per_program"), log)
        row = {"seed": seed, "seconds": window.seconds, **numbers}
        log(json.dumps(row))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--set", action="append", default=None,
                    help="a StarkConfig setting of the control, key=value")
    args = ap.parse_args(argv)
    from zkbench import harness
    cell = harness.cell_of(harness.load_spec(), args.workload)
    readings(cell, [int(s) for s in args.seeds.split(",")],
             args.set or ["num_query_rounds=28"],
             log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
