# Frozen copy of zkm_tpu_torch/emulator/utils.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Execution drivers: load + split programs into segments.

Copy of zkm_tpu/emulator/utils.py (zkMIPS emulator/src/utils.rs).  Each
function hashes pages on its state's device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .state import (InstrumentedState, PAGE_CYCLES, RESERVE_CYCLES, Segment,
                    State, SEGMENT_STEPS)


# frozen: left out, as only the prover uses them: load_elf_with_patch,
# load_segment, split_seg_into_segs.


def split_prog_into_segs(state: State, seg_path: Optional[str] = None,
                         block_path: str = "",
                         seg_size: int = SEGMENT_STEPS,
                         max_steps: Optional[int] = None
                         ) -> Tuple[int, List[Segment], State]:
    """Run to completion, splitting by cycle budget.

    Returns (total_steps, segments, final state).  Segments are returned
    in-memory and also written to seg_path if given.

    With a native-core state the hot loop runs in C++ in chunks sized to
    half the remaining cycle budget (each step costs >= 1 cycle, so the
    split lands at most one chunk past the budget — segment boundaries may
    exceed seg_size slightly, which the continuation protocol permits, and
    differ from the Python path's).
    """
    ist = InstrumentedState(state, block_path)
    native = hasattr(state.memory, "run")
    if seg_path:
        os.makedirs(seg_path, exist_ok=True)
    ist.split_segment(False)
    segments: List[Segment] = []
    while True:
        if native:
            est = (ist.state.cycle
                   + (ist.state.memory.page_count() + 1) * PAGE_CYCLES
                   + RESERVE_CYCLES)
            budget = max(1, (seg_size - est) // 2) if est < seg_size else 1
            ist.run_fast(budget)
            cycles = (ist.state.cycle
                      + (ist.state.memory.page_count() + 1) * PAGE_CYCLES
                      + RESERVE_CYCLES)
        else:
            cycles = ist.step()
        if ist.state.exited:
            break
        if max_steps is not None and \
                ist.state.total_step + ist.state.step >= max_steps:
            raise RuntimeError(f"exceeded max_steps={max_steps}")
        if cycles > seg_size - 1:
            segments.append(ist.split_segment(True, seg_path))
    segments.append(ist.split_segment(True, seg_path))
    return ist.state.total_step, segments, ist.state

