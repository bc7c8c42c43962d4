"""Shrink-circuit serialization + shape-keyed on-disk cache.

Copy of zkm_tpu/recursion/cache.py.  zkMIPS serializes
AllRecursiveCircuits and every per-table/per-degree sub-circuit to bytes
so the (minutes-long) circuit build is paid once (fixed_recursive_verifier.rs:313-373), and indexes
circuits by per-table degree-bits ranges (recursion/src/lib.rs:32-45).

Here the recorded verifier DAG is per proof-SHAPE: the shape key hashes
everything the recording depends on — table set (stark types + column
counts + public-input counts), per-table degree bits and aux/quotient
opening widths, CTL topology, and FRI config.  `build_shrink_circuit_cached`
returns a disk-cached circuit when the shape was recorded before (by any
process), so recursion no longer re-records per process.  The cache lives
in `cache_dir`, by default `CACHE_DIR` inside the package.  A circuit
holds numpy arrays and python ints only (no tensor), so it loads on any
device.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from ..stark.config import StarkConfig
from ..stark.proof import AllProof
from ..utils.timing import log, step

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_circuits")

FORMAT_VERSION = 1


def proof_shape_key(starks: Sequence, ctls, config: StarkConfig,
                    template: AllProof, tag: str = "") -> str:
    """Stable key for 'same recorded DAG' (see module docstring)."""
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION};{tag};".encode())
    fc = config.fri_config
    h.update(f"cfg:{config.num_challenges},{fc.rate_bits},{fc.cap_height},"
             f"{fc.proof_of_work_bits},{fc.num_query_rounds},"
             f"{fc.arity_bits},{fc.final_poly_bits};".encode())
    for s, p in zip(starks, template.stark_proofs):
        op = p.proof.openings
        h.update(f"t:{type(s).__name__},{s.num_columns},"
                 f"{s.num_public_inputs},{p.degree_bits},"
                 f"{len(op.auxiliary_polys)},{len(op.quotient_polys)},"
                 f"{len(op.ctl_zs_first)};".encode())
    h.update(f"ctls:{len(ctls)};".encode())
    for c in ctls:
        for t in c.looking_tables:
            h.update(f"lk:{t.table},{len(t.columns)};".encode())
        h.update(f"ld:{c.looked_table.table},"
                 f"{len(c.looked_table.columns)};".encode())
    return h.hexdigest()[:32]


def save_circuit(circuit, path: str) -> None:
    """Serialize a ShrinkCircuit: the DAG op stream, program tables, and
    verifying key (stark instances are reconstructed — they're stateless)."""
    dag = circuit.vdag.dag
    payload = {
        "format": FORMAT_VERSION,
        "dag_prog": dag.prog,
        "dag_n": dag.n,
        "dag_pub": dag.pub,
        "dag_asserts": dag.asserts,
        "dag_num_poseidons": dag.num_poseidons,
        "num_public_inputs": circuit.vdag.num_public_inputs,
        "claim_wires": circuit.vdag.claim_wires,
        "op_rows": circuit.prog.op_rows,
        "pose_rows": circuit.prog.pose_rows,
        "prog_claim_wires": circuit.prog.claim_wires,
        "config": circuit.config,
        "program_cap": np.asarray(circuit.program_cap),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_circuit(path: str):
    """Reconstruct a ShrinkCircuit saved by save_circuit (a file this
    program wrote: unpickling runs code)."""
    from .dag import Dag
    from .shrink import (ShrinkCircuit, _Program, make_shrink_ctls,
                         make_shrink_starks)
    from .verifier_dag import VerifierDag

    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != FORMAT_VERSION:
        raise ValueError(f"circuit cache format {payload.get('format')} "
                         f"!= {FORMAT_VERSION}")
    dag = Dag.__new__(Dag)
    dag.prog = payload["dag_prog"]
    dag.n = payload["dag_n"]
    dag.cse = {}
    dag.cval = {}
    dag.pub = payload["dag_pub"]
    dag.asserts = payload["dag_asserts"]
    dag.num_poseidons = payload["dag_num_poseidons"]
    dag.zero = None
    dag.one = None
    vdag = VerifierDag(dag=dag, wproof=None,
                       num_public_inputs=payload["num_public_inputs"],
                       claim_wires=payload["claim_wires"])
    prog = _Program(op_rows=payload["op_rows"],
                    pose_rows=payload["pose_rows"],
                    claim_wires=payload["prog_claim_wires"])
    return ShrinkCircuit(
        vdag=vdag, prog=prog, starks=make_shrink_starks(),
        ctls=make_shrink_ctls([int(w) for w in prog.claim_wires]),
        config=payload["config"],
        program_cap=payload["program_cap"])


def build_shrink_circuit_cached(inner_starks: Sequence, inner_ctls,
                                inner_config: StarkConfig,
                                template: AllProof,
                                config: Optional[StarkConfig] = None,
                                cap_pins=None,
                                cache_dir: Optional[str] = None,
                                device=None, timer=None):
    """build_shrink_circuit with a shape-keyed disk cache in `cache_dir`
    (default CACHE_DIR).

    cap_pins participate in the recorded DAG (VK constants), so they are
    folded into the key."""
    from .shrink import build_shrink_circuit

    cache_dir = cache_dir or CACHE_DIR
    tag = ""
    if cap_pins:
        hp = hashlib.sha256()
        for t in sorted(cap_pins):
            hp.update(np.asarray(cap_pins[t], dtype=np.uint64).tobytes())
            hp.update(str(t).encode())
        tag = hp.hexdigest()[:16]
    key = proof_shape_key(inner_starks, inner_ctls,
                          config or inner_config, template, tag=tag)
    path = os.path.join(cache_dir, f"shrink_{key}.pkl")
    if os.path.exists(path):
        with step(timer, "load_circuit"):
            try:
                return load_circuit(path)
            except (OSError, ValueError, EOFError,
                    pickle.UnpicklingError) as e:   # stale/corrupt: rebuild
                log("warn", "circuit cache load failed (%s); rebuilding", e)
    circuit = build_shrink_circuit(inner_starks, inner_ctls, inner_config,
                                   template, config=config,
                                   cap_pins=cap_pins, device=device,
                                   timer=timer)
    with step(timer, "save_circuit"):
        save_circuit(circuit, path)
    return circuit
