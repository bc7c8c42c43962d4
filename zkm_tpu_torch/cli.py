"""Command-line entry points, mirroring the reference's env-var example
binaries.

Copy of zkm_tpu/cli.py (zkMIPS prover/examples/{split-seg,prove-seg}/
src/main.rs): the same commands, variables, files and layout.

Usage:
  python -m zkm_tpu_torch.cli split-seg   ELF_PATH=... SEG_OUTPUT=... [SEG_SIZE=65536] [ARGS="a b"]
  python -m zkm_tpu_torch.cli prove-seg   SEG_FILE=... [DEBUG=1]
  python -m zkm_tpu_torch.cli prove-elf   ELF_PATH=... [SEG_SIZE=...] [ARGS=...]
  python -m zkm_tpu_torch.cli wrap        PROOF_JSON=... OUTPUT_DIR=...
(variables read from the environment, like the reference binaries)

Every command runs on the card and raises without one; DEVICE=cpu is the
only way to run on the CPU.  The commands that run the emulator or the
prover also print their steps' times and their K1/K2 launches.  `wrap`
reads its Groth16 proving key from ZKM_CIRCUIT_CACHE when that is set,
else from the port's `recursion.cache.CACHE_DIR`, and makes it there
(~100 s of host time) when it is missing.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .device import resolve_device
from .emulator.state import Segment
from .emulator.utils import load_elf_with_patch, split_prog_into_segs
from .field import ntt
from .hash import poseidon as ps
from .host import prove_elf, prove_segment, verify_segment_receipt
from .stark.config import StarkConfig
from .utils.timing import StepTimer, step


def _env(name, default=None, required=False):
    v = os.environ.get(name, default)
    if required and v is None:
        sys.exit(f"missing required env var {name}")
    return v


def _report(timer: StepTimer) -> None:
    steps = ", ".join(f"{k} {v * 1e3:.1f} ms"
                      for k, v in timer.seconds.items())
    print(f"steps: {steps}; launches: K1 {ps.LAUNCHES}, K2 {ntt.LAUNCHES}")


def cmd_split_seg(dev):
    elf = _env("ELF_PATH", required=True)
    out = _env("SEG_OUTPUT", required=True)
    seg_size = int(_env("SEG_SIZE", "65536"))
    args = (_env("ARGS", "") or "").split()
    timer = StepTimer(dev)
    with step(timer, "emulate"):
        state = load_elf_with_patch(elf, args, dev)
        total, segs, _ = split_prog_into_segs(state, out, "", seg_size)
    print(f"split done: {total} steps into {len(segs)} segments at {out}")
    _report(timer)


def cmd_prove_seg(dev):
    seg_file = _env("SEG_FILE", required=True)
    with open(seg_file) as f:
        seg = Segment.from_json(f.read())
    debug = bool(int(_env("DEBUG", "0")))
    timer = StepTimer(dev)
    receipt = prove_segment(seg, StarkConfig.standard_fast_config(),
                            device=dev, timer=timer, debug=debug)
    verify_segment_receipt(receipt)
    print(f"segment {seg.segment_id} proved and verified; "
          f"image id {receipt.image_id.hex()}")
    _report(timer)


def cmd_prove_elf(dev):
    elf = _env("ELF_PATH", required=True)
    seg_size = int(_env("SEG_SIZE", "65536"))
    args = (_env("ARGS", "") or "").split()
    timer = StepTimer(dev)
    receipts = prove_elf(elf, args, seg_size=seg_size, device=dev,
                         timer=timer)
    for r in receipts:
        verify_segment_receipt(r)
    print(f"proved {len(receipts)} segments; final image id "
          f"{receipts[-1].image_id.hex()}")
    _report(timer)


def cmd_wrap(dev):
    """STARK -> Groth16 wrap of an exported (already verified) proof:
    the as_groth16 / SetupAndGenerateSolVerifier command analog
    (recursion/src/lib.rs:162-169, libsnark/snark_prover.go:262-309).
    It runs on the host; `dev` only says that a card was found.

    PROOF_JSON=exported proof path; OUTPUT_DIR=where to write
    snark_proof_with_public_inputs.json and verifier.sol."""
    proof_path = _env("PROOF_JSON", required=True)
    out_dir = _env("OUTPUT_DIR", required=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(proof_path) as f:
        doc = json.load(f)

    from .snark import wrap as snark_wrap
    from .snark.contract import emit_verifier_sol

    t0 = time.perf_counter()
    pk = snark_wrap.groth16_setup(cache_dir=_env("ZKM_CIRCUIT_CACHE"))
    t1 = time.perf_counter()
    wrapped = snark_wrap.wrap_stark_bn254(doc, pk)
    t2 = time.perf_counter()
    proof_out = os.path.join(out_dir, "snark_proof_with_public_inputs.json")
    with open(proof_out, "w") as f:
        f.write(wrapped.to_json())
    sol_out = os.path.join(out_dir, "verifier.sol")
    with open(sol_out, "w") as f:
        f.write(emit_verifier_sol(pk.vk))
    print(f"wrapped: {proof_out} + {sol_out}; "
          f"claim digest (MiMC) {wrapped.public_inputs[0]}")
    print(f"steps: key {(t1 - t0) * 1e3:.1f} ms, prove and verify "
          f"{(t2 - t1) * 1e3:.1f} ms")


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    cmd = sys.argv[1].replace("-", "_")
    fn = globals().get(f"cmd_{cmd}")
    if fn is None:
        sys.exit(f"unknown command {sys.argv[1]}\n{__doc__}")
    fn(resolve_device(_env("DEVICE") or None))


if __name__ == "__main__":
    main()
