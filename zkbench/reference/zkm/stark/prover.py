# Frozen copy of zkm_tpu_torch/stark/prover.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Multi-table STARK prover: only the two helpers the verifier imports.

Counterpart of `zkm_tpu/stark/prover.py` (zkMIPS prover/src/prover.rs).
frozen: the proving functions and their imports are left out.
"""

from __future__ import annotations

from ..iop.challenger import Challenger
from .proof import PublicValues

def observe_public_values(challenger: Challenger, pv: PublicValues):
    challenger.observe_elements(pv.roots_before.root)
    challenger.observe_elements(pv.roots_after.root)
    challenger.observe_elements(list(pv.userdata))


def public_inputs_of(stark, pv: PublicValues) -> tuple:
    """The per-table public-input scalars selected from the proof claim."""
    if not stark.num_public_inputs:
        return ()
    return tuple(stark.public_inputs(
        [int(v) for v in pv.roots_before.root],
        [int(v) for v in pv.roots_after.root],
        [int(b) for b in pv.userdata]))
