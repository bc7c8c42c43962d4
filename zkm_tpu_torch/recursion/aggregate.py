"""Stage R3: binary aggregation tree + block chaining.

Copy of zkm_tpu/recursion/aggregate.py (analog of zkMIPS
prover/src/fixed_recursive_verifier.rs:920-980, `prove_aggregation`:
cyclic binary nodes over (agg|root) children, and :991-1067,
`prove_block`: chaining across blocks, driven pairwise by
prover/examples/utils/src/utils.rs:105-154).

The node (recursion/shrink.py `build_aggregation_circuit`) is one
recorded DAG verifying both children with their verifying keys
(program-table caps) pinned in-DAG, plus the continuation equalities.
Where the reference uses ONE cyclic circuit whose children carry their
verifier data as public inputs, this tree builds one circuit per
distinct (child shapes, child verifying keys) signature, lazily, and
caches it — levels of a balanced tree share a signature, so a tree of any
width needs O(log distinct-shapes) recordings, and every node at a level
is an independent proof.

The tree proves on its `device` (the card unless device='cpu'); each
shrink or pair takes a `timer` for its steps.  With `disk_cache` node
circuits are kept in `cache_dir` (recursion/cache.py) across processes.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..stark.proof import AllProof
from ..utils.timing import log, step
from .cache import CACHE_DIR, load_circuit, save_circuit
from .shrink import (ShrinkCircuit, build_aggregation_circuit,
                     prove_aggregation, prove_shrink, verify_shrink)


@dataclass
class AggItem:
    """A proof in the tree plus the verifying key of its circuit."""
    proof: AllProof
    program_cap: np.ndarray

    def key(self) -> tuple:
        shape = tuple(pm.degree_bits for pm in self.proof.stark_proofs)
        return (shape, self.program_cap.tobytes())


class AggregationTree:
    """Shrinks segment proofs and binary-reduces them to one root receipt.

    `shrink_circuit` is the per-segment shrink circuit (stage R2) whose
    program cap anchors the leaves.  Node circuits are recorded lazily per
    (child-shapes, child-VKs) signature and cached for reuse across pairs
    and trees."""

    def __init__(self, shrink_circuit: ShrinkCircuit,
                 disk_cache: bool = True, cache_dir: Optional[str] = None,
                 device=None):
        self.shrink_circuit = shrink_circuit
        self.device = resolve_device(device)
        self._circuits: Dict[tuple, ShrinkCircuit] = {}
        self._disk_cache = disk_cache
        self._cache_dir = cache_dir or CACHE_DIR
        # verifying-key index: program cap -> the circuit that verifies
        # proofs carrying it (for assumption/receipt verification)
        self._by_cap: Dict[bytes, ShrinkCircuit] = {
            np.asarray(shrink_circuit.program_cap).tobytes(): shrink_circuit}

    def circuit_for(self, item: "AggItem") -> ShrinkCircuit:
        """The circuit whose verifying key (program cap) signed `item`."""
        cap = np.asarray(item.program_cap).tobytes()
        try:
            return self._by_cap[cap]
        except KeyError:
            raise KeyError("no circuit known for this verifying key "
                           "(foreign program cap)") from None

    # -- leaves ---------------------------------------------------------------

    def shrink(self, inner_proof: AllProof, timer=None) -> AggItem:
        """Shrink one inner proof ("shrink_verify": the check of the
        result)."""
        proof = prove_shrink(self.shrink_circuit, inner_proof,
                             device=self.device, timer=timer)
        with step(timer, "shrink_verify"):
            verify_shrink(self.shrink_circuit, proof)
        return AggItem(proof, self.shrink_circuit.program_cap)

    # -- nodes ----------------------------------------------------------------

    def node_circuit(self, lhs: AggItem, rhs: AggItem,
                     timer=None) -> ShrinkCircuit:
        key = (lhs.key(), rhs.key())
        circuit = self._circuits.get(key)
        if circuit is None:
            circuit = self._node_circuit_disk(key) \
                if self._disk_cache else None
            if circuit is None:
                circuit = build_aggregation_circuit(
                    self.shrink_circuit.starks, self.shrink_circuit.ctls,
                    self.shrink_circuit.config,
                    [lhs.proof, rhs.proof],
                    [lhs.program_cap, rhs.program_cap],
                    device=self.device, timer=timer)
                if self._disk_cache:
                    save_circuit(circuit, self._node_path(key))
            self._circuits[key] = circuit
        self._by_cap[np.asarray(circuit.program_cap).tobytes()] = circuit
        return circuit

    def _node_path(self, key: tuple) -> str:
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self._cache_dir, f"aggnode_{h}.pkl")

    def _node_circuit_disk(self, key):
        """Load a node circuit recorded by a previous process (zkMIPS
        serializes all recursion circuits,
        fixed_recursive_verifier.rs:313-373); None when there is none or it
        does not load."""
        path = self._node_path(key)
        if not os.path.exists(path):
            return None
        try:
            return load_circuit(path)
        except (OSError, ValueError, EOFError, pickle.UnpicklingError) as e:
            log("warn", "aggregation circuit %s does not load (%s); "
                "recording it again", path, e)
            return None

    def aggregate_pair(self, lhs: AggItem, rhs: AggItem,
                       timer=None) -> AggItem:
        """One aggregation node: its circuit (recorded once per
        signature), the proof of both children and its check
        ("agg_verify")."""
        circuit = self.node_circuit(lhs, rhs, timer)
        proof = prove_aggregation(circuit, [lhs.proof, rhs.proof],
                                  device=self.device, timer=timer)
        with step(timer, "agg_verify"):
            verify_shrink(circuit, proof)
        return AggItem(proof, circuit.program_cap)

    def aggregate(self, items: Sequence[AggItem], timer=None) -> AggItem:
        """Binary tree reduction; an odd item is carried up a level.  Every
        pair at a level is an independent proof."""
        level: List[AggItem] = list(items)
        if not level:
            raise ValueError("nothing to aggregate")
        while len(level) > 1:
            nxt = [self.aggregate_pair(level[i], level[i + 1], timer)
                   for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]

    # -- blocks ----------------------------------------------------------------
    # The block node IS the aggregation node applied across blocks: the
    # continuation equality lhs.roots_after == rhs.roots_before is exactly
    # the block chain (fixed_recursive_verifier.rs:756-766).  The genesis
    # base case has no parent, so the block receipt is the block's own
    # aggregated proof (the reference inserts a cyclic dummy proof instead
    # because its circuit shape demands two children).

    def prove_block(self, parent: Optional[AggItem],
                    block_agg: AggItem) -> AggItem:
        if parent is None:
            return block_agg
        return self.aggregate_pair(parent, block_agg)

    # -- composition (assumption discharge) -------------------------------------
    # Reference analog: `verify_block` verifies every proven assumption's
    # receipt as part of accepting a composite block receipt
    # (fixed_recursive_verifier.rs:1069-1092 — the assumption check is
    # host-side `verify_root` there too; the in-circuit part is the
    # program proof itself).  Here the assumption receipt is a
    # recursion-level AggItem (shrunk or aggregated), so discharge =
    # verify_shrink under the verifying key that signed it + claim-digest
    # equality against what the program's SYS_VERIFY consumed.

    def compose_block(self, program: AggItem,
                      assumptions: Sequence["AssumptionProof"]
                      ) -> "CompositeBlockReceipt":
        return CompositeBlockReceipt(
            program=program,
            assumptions=[(ap.claim_digest(), ap) for ap in assumptions])

    def verify_block_receipt(self, receipt: "CompositeBlockReceipt"):
        """verify_block analog: the program chain proof, then every
        assumption's own recursion proof (under ITS verifying key) and its
        claim digest binding."""
        verify_shrink(self.circuit_for(receipt.program),
                      receipt.program.proof)
        for claim, ap in receipt.assumptions:
            if ap.claim_digest() != claim:
                raise ValueError("assumption claim digest mismatch")
            verify_shrink(self.circuit_for(ap.item), ap.item.proof)


@dataclass
class AssumptionProof:
    """A proven assumption at recursion level: the assumed execution's
    shrunk/aggregated proof.  Exposes `claim_digest()` so it can be passed
    directly in the witness-generation assumption environment
    (receipts.find_assumption duck-types on claim_digest)."""
    item: AggItem

    def claim_digest(self) -> bytes:
        pv = self.item.proof.public_values
        return hashlib.sha256(pv.roots_before.to_image_id()
                              + pv.userdata).digest()


@dataclass
class CompositeBlockReceipt:
    """Block receipt + the assumption proofs it depends on (reference
    CompositeReceipt at the recursion level)."""
    program: AggItem
    assumptions: List[Tuple[bytes, AssumptionProof]]
