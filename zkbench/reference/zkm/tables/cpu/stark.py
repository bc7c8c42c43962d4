# Frozen copy of zkm_tpu_torch/tables/cpu/stark.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""CPU STARK constraints.

Copy of zkm_tpu/tables/cpu/stark.py.  Reference: zkMIPS
prover/src/cpu/cpu_stark.rs:260-285 composes the
constraint groups; each group lives in its own method below (bootstrap,
decode, jumps/branches, membus, memio, shift, count, syscall, bits, misc).

Strengthened beyond the reference (see SOUNDNESS.md):
  * per-flag opcode/func binding — every op flag is tied to the decoded
    instruction bits (the reference's decode.rs leaves classification TODO);
  * pc chaining across consecutive cpu-cycle rows;
  * unused reference flags (eq_iszero, keccak_general, pc, get/set_context,
    exit_kernel op) are pinned to zero.
"""

from __future__ import annotations

from ...stark.stark import Stark
from . import columns as cc
from . import constraints as cons


class CpuStark(Stark):
    num_columns = cc.NUM_CPU_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        cons.eval_bootstrap(a, lv, nv, consumer)
        cons.eval_decode(a, lv, consumer)
        cons.eval_flag_opcode_binding(a, lv, consumer)
        cons.eval_pc_chain(a, lv, nv, consumer)
        cons.eval_jumps(a, lv, nv, consumer)
        cons.eval_branch(a, lv, nv, consumer)
        cons.eval_membus(a, lv, consumer)
        cons.eval_memio(a, lv, consumer)
        cons.eval_shift(a, lv, consumer)
        cons.eval_count(a, lv, consumer)
        cons.eval_syscall(a, lv, consumer)
        cons.eval_bits(a, lv, consumer)
        cons.eval_misc(a, lv, consumer)


class CpuStarkImageBound(CpuStark):
    """CpuStark + constraint-level PublicValues binding.

    Used whenever the Poseidon sponge chain is in the proving subset (the
    bootstrap/exit kernels then emit the image-id sponge rows this binding
    designates).  16 public inputs: roots_before ++ roots_after as u32
    words — the exact PublicValues layout the challenger observes
    (prover.rs observe_public_values).  An otherwise-valid proof whose
    claimed roots differ from the witnessed image ids fails the quotient
    identity; the reference only asserts this witness-side
    (bootstrap_kernel.rs:166-174)."""

    num_public_inputs = 16

    def public_inputs(self, roots_before, roots_after, userdata) -> list:
        return list(roots_before) + list(roots_after)

    def eval_generic(self, a, lv, nv, consumer, publics=None):
        assert publics is not None and len(publics) == 16
        super().eval_generic(a, lv, nv, consumer)
        cons.eval_image_id_binding(a, lv, nv, consumer, publics)
