"""The port stands alone: importing zkm_tpu_torch, every submodule and
chip_smoke.py loads neither jax nor any module of zkm_tpu."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import zkm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zkm_tpu_torch.__path__,
                                               "zkm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "zkm_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("stark.prover", "native", "emulator.state",
                 "witness.generation", "runtime.examples", "receipts",
                 "export", "recursion", "recursion.dag",
                 "recursion.symbolic", "recursion.verifier_dag",
                 "recursion.shrink", "recursion.aggregate",
                 "recursion.cache", "snark", "snark.bn254", "snark.r1cs",
                 "snark.mimc", "snark.groth16", "snark.wrap",
                 "snark.contract", "cli", "emulator.native",
                 "runtime.build", "parallel", "parallel.comm",
                 "parallel.sharding", "parallel.launch"):
        assert "zkm_tpu_torch." + name in result["imported"]
    assert result["bad"] == []
