"""Execution drivers: load + split programs into segments.

Copy of zkm_tpu/emulator/utils.py (zkMIPS emulator/src/utils.rs).  Each
function hashes pages on its state's device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .state import (InstrumentedState, PAGE_CYCLES, RESERVE_CYCLES, Segment,
                    State, SEGMENT_STEPS)


def load_elf_with_patch(elf_path: str, args: List[str], device=None,
                        native: bool = False) -> State:
    with open(elf_path, "rb") as f:
        data = f.read()
    state = State.load_elf_bytes(data, device, native)
    state.patch_elf()
    state.patch_stack(args)
    return state


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


def load_segment(seg_file: str, device=None) -> Tuple[State, int]:
    with open(seg_file) as f:
        seg = Segment.from_json(f.read())
    return State.load_seg(seg, device)


def split_seg_into_segs(seg: Segment, seg_path: Optional[str] = None,
                        block_path: str = "",
                        seg_size: int = SEGMENT_STEPS, device=None
                        ) -> Tuple[int, List[Segment], State]:
    """Re-split one (oversized) segment into smaller segments
    (emulator/src/utils.rs:62-104).

    Resumes execution from the segment's pre-state and splits by the new
    cycle budget, stopping exactly at the original segment's step count so
    the resulting chain's first pre_image_id and last image_id match the
    input segment's."""
    state, final_step = State.load_seg(seg, device)
    ist = InstrumentedState(state, block_path)
    if seg_path:
        os.makedirs(seg_path, exist_ok=True)
    ist.split_segment(False)
    segments: List[Segment] = []
    while True:
        cycles = ist.step()
        if ist.state.total_step + ist.state.step == final_step:
            break
        if cycles > seg_size - 1:
            segments.append(ist.split_segment(True, seg_path))
    segments.append(ist.split_segment(True, seg_path))
    return ist.state.total_step, segments, ist.state
