"""Receipts, claims, and assumption composition.

Copy of zkm_tpu/receipts.py (zkMIPS prover/src/generation/state.rs:23-206:
Assumption, ReceiptClaim, InnerReceipt, AssumptionReceipt,
CompositeReceipt, Receipt; prover/examples/sha2-composition for the
composition pattern).

A *claim* is (elf_id = pre image id of the proven execution, commit = the
committed public output); its digest is SHA256(elf_id ‖ commit).  A guest
calls the `verify` syscall with a claim digest; witness generation
resolves it against the provided assumption receipts (`find_assumption`,
operation.rs:991-1022) and records the usage, producing a
`CompositeReceipt` whose validity is conditional on its assumptions.
Host-side `verify_receipt` walks the closure: the program receipt's
segment chain plus every proven assumption, recursively.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


@dataclass(frozen=True)
class Assumption:
    """An unresolved claim digest (generation/state.rs:23-26)."""
    claim: bytes                    # 32-byte digest

    def claim_digest(self) -> bytes:
        return self.claim


@dataclass
class ReceiptClaim:
    """What an execution proved (generation/state.rs:29-33)."""
    elf_id: bytes                   # pre image id of the first segment
    commit: bytes                   # committed public values (userdata)


def claim_digest(claim: ReceiptClaim) -> bytes:
    h = hashlib.sha256()
    h.update(claim.elf_id)
    h.update(claim.commit)
    return h.digest()


@dataclass
class InnerReceipt:
    """Segment-chain proof + claim (generation/state.rs:36-55).

    `segments` holds the per-segment STARK receipts until the aggregation
    layer compresses chains into one proof (docs/recursion.md stage R3)."""
    segments: List                  # [host.SegmentReceipt]
    claim: ReceiptClaim

    def claim_digest(self) -> bytes:
        return claim_digest(self.claim)


@dataclass
class AssumptionReceipt:
    """Proven or unresolved assumption (generation/state.rs:58-80)."""
    proven: Optional["Receipt"] = None
    unresolved: Optional[Assumption] = None

    def claim_digest(self) -> bytes:
        if self.proven is not None:
            return self.proven.claim_digest()
        return self.unresolved.claim_digest()

    @property
    def is_proven(self) -> bool:
        return self.proven is not None


@dataclass
class CompositeReceipt:
    """Program receipt + the assumptions its proof used
    (generation/state.rs:108-132)."""
    program_receipt: InnerReceipt
    assumptions_used: List[Tuple[Assumption, AssumptionReceipt]] = \
        field(default_factory=list)

    def claim_digest(self) -> bytes:
        return self.program_receipt.claim_digest()


@dataclass
class Receipt:
    """Receipt::{Segments, Composite} (generation/state.rs:135-186)."""
    inner: Union[InnerReceipt, CompositeReceipt]

    @classmethod
    def segments(cls, r: InnerReceipt) -> "Receipt":
        return cls(inner=r)

    @classmethod
    def composite(cls, r: CompositeReceipt) -> "Receipt":
        return cls(inner=r)

    def claim_digest(self) -> bytes:
        return self.inner.claim_digest()

    def claim(self) -> ReceiptClaim:
        if isinstance(self.inner, CompositeReceipt):
            return self.inner.program_receipt.claim
        return self.inner.claim

    def program_receipt(self) -> InnerReceipt:
        if isinstance(self.inner, CompositeReceipt):
            return self.inner.program_receipt
        return self.inner

    def assumptions(self) -> List[Tuple[Assumption, AssumptionReceipt]]:
        if isinstance(self.inner, CompositeReceipt):
            return self.inner.assumptions_used
        return []


def find_assumption(claim: bytes,
                    receipts: List[AssumptionReceipt]) -> AssumptionReceipt:
    """Resolve a SYS_VERIFY claim digest against the environment's
    assumption receipts (operation.rs find_assumption semantics: panic if
    absent)."""
    for r in receipts:
        if r.claim_digest() == claim:
            return r
    raise KeyError(f"Assumption Not Found: {claim.hex()}")


def verify_receipt(receipt: Receipt, config=None, all_stark=None,
                   allow_unresolved: bool = False) -> None:
    """Verify the receipt closure: every segment proof of the program
    receipt (chained), then every used assumption (recursively for proven
    ones; unresolved ones fail unless `allow_unresolved`)."""
    from .host import check_receipt_chain, verify_segment_receipt

    inner = receipt.program_receipt()
    for seg_receipt in inner.segments:
        verify_segment_receipt(seg_receipt, config, all_stark)
    check_receipt_chain(inner.segments)
    if inner.segments:
        if inner.segments[0].pre_image_id != inner.claim.elf_id:
            raise ValueError("claim elf_id != first segment pre image id")
        if inner.segments[0].userdata != inner.claim.commit:
            raise ValueError("claim commit != proven userdata")
    for assumption, areceipt in receipt.assumptions():
        if assumption.claim != areceipt.claim_digest():
            raise ValueError("assumption/receipt digest mismatch")
        if areceipt.is_proven:
            verify_receipt(areceipt.proven, config, all_stark,
                           allow_unresolved)
        elif not allow_unresolved:
            raise ValueError(
                f"unresolved assumption {assumption.claim.hex()}")
