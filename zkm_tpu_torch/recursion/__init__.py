"""Recursion / aggregation layer (docs/recursion.md), the counterpart of
zkm_tpu/recursion.

Stage R1: the multi-table STARK verifier recorded as a flat arithmetic DAG
over Goldilocks wires (analog of zkMIPS prover/src/recursive_verifier.rs
`recursive_stark_circuit`).  Stage R2 lowers the DAG to the uniform
Verifier tables proven by the same STARK engine (shrink); stage R3
aggregates shrunk proofs pairwise into one root.
"""

from ..stark.proof import flatten_proof
from .dag import Dag, Wire, ReplayFailure, evaluate
from .verifier_dag import VerifierDag, record_chain, record_verifier
from .shrink import (ShrinkCircuit, build_aggregation_circuit,
                     build_shrink_circuit, prove_aggregation, prove_shrink,
                     verify_shrink)
from .aggregate import AggItem, AggregationTree

__all__ = [
    "Dag", "Wire", "ReplayFailure", "evaluate",
    "VerifierDag", "flatten_proof", "record_verifier", "record_chain",
    "ShrinkCircuit", "build_shrink_circuit", "prove_shrink", "verify_shrink",
    "build_aggregation_circuit", "prove_aggregation",
    "AggItem", "AggregationTree",
]
