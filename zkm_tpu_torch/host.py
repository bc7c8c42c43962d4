"""Host-facing proving API: a segment's witness -> a multi-table proof.

Counterpart of zkm_tpu/host.py:83-163 (`segment_traces`, `prove_segment`,
`verify_segment_receipt`) from the witness on: the port has no emulator
and no witness generation yet, so its input is a `TraceSet`
(witness/trace_set.py) rather than a `Segment`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .convert import traces_from_rows
from .device import resolve_device
from .stark.all_stark import AllStark, Table, make_all_stark
from .stark.config import StarkConfig
from .stark.proof import AllProof, PublicValues
from .stark.prover import prove_with_traces
from .stark.verifier import verify_proof
from .tables import arithmetic as arith
from .tables import logic
from .tables import memory as mem
from .tables import poseidon
from .tables import poseidon_sponge as psponge
from .utils.timing import step
from .witness.trace_set import TraceSet, pad_cpu_rows


def segment_traces(trace_set: TraceSet, all_stark: AllStark,
                   height_floors: Optional[Dict[Table, int]] = None,
                   device=None) -> List[np.ndarray]:
    """Per-table (C, N) u64 trace rows of the subset.

    height_floors: {Table: min_rows} degree buckets; unlisted tables pad to
    their natural power-of-two height (at least 64 rows, Arithmetic at
    least RANGE_MIN_ROWS, PoseidonSponge at least MIN_ROWS).  Padding rows
    are each table's own, so a proof stays valid at any floor.  The sponge
    chains of the PoseidonSponge builder run on the card unless
    device='cpu'."""
    floors = dict(height_floors or {})
    t = trace_set

    def floor_of(tab, default=64):
        return max(floors.get(tab, 0), default)

    builders = {
        Table.Arithmetic: lambda f: arith.generate_rows(
            t.arith_ops, min_rows=max(f, arith.RANGE_MIN_ROWS)),
        Table.Cpu: lambda f: pad_cpu_rows(t.cpu_rows, f).T.copy(),
        Table.Poseidon: lambda f: poseidon.generate_rows(
            t.poseidon_inputs, min_rows=f),
        Table.PoseidonSponge: lambda f: psponge.generate_rows(
            t.poseidon_sponge_ops, min_rows=max(f, psponge.MIN_ROWS),
            device=device),
        Table.Logic: lambda f: logic.generate_rows(t.logic_ops, min_rows=f),
        Table.Memory: lambda f: mem.generate_rows(t.memory_ops, min_rows=f),
    }
    return [builders[tab](floor_of(tab)) for tab in all_stark.tables]


def prove_trace_set(trace_set: TraceSet, pv: PublicValues,
                    config: Optional[StarkConfig] = None,
                    all_stark: Optional[AllStark] = None,
                    height_floors: Optional[Dict[Table, int]] = None,
                    device=None, timer=None) -> AllProof:
    """Build the subset's traces and prove them (default: SPONGE_SUBSET
    under standard_fast_config).  Runs on the card unless device='cpu';
    `timer` (a utils.timing.StepTimer) collects per-step seconds, with
    the trace build as "trace_build"."""
    dev = resolve_device(device)
    config = config or StarkConfig.standard_fast_config()
    all_stark = all_stark or make_all_stark()
    with step(timer, "trace_build"):
        rows = segment_traces(trace_set, all_stark, height_floors, dev)
    return prove_with_traces(all_stark.starks, config,
                             traces_from_rows(rows, dev), all_stark.ctls, pv,
                             device=dev, timer=timer)


def verify_segment(proof: AllProof, config: Optional[StarkConfig] = None,
                   all_stark: Optional[AllStark] = None) -> None:
    """Raise ValueError unless `proof` verifies (host verifier)."""
    config = config or StarkConfig.standard_fast_config()
    all_stark = all_stark or make_all_stark()
    verify_proof(all_stark.starks, proof, all_stark.ctls, config)
