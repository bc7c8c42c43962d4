#!/usr/bin/env python3
"""Run one cell of the benchmark of zkm_tpu_torch once, on this machine's
cards:

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the numbers that decide `correct` are the last
lines of standard error.  With --trace 0 the metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
device trace of the window.  Exits nonzero, printing no result, without
enough CUDA cards, outside a checkout that holds the port, or if JAX or
the JAX package were loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Every build and kernel cache of the run stays at a fixed path inside the
# checkout (K1 and K2 build into zkm_tpu_torch/_build/ on their own).
CACHE = os.path.join(ROOT, "zkbench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from zkbench import harness
    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)

    import torch
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"needs {need} CUDA card(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))

    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}")
        return 4
    for k, v in result["compared"].items():
        harness.log(f"{k} {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
