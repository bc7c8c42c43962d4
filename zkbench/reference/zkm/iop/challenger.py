# Frozen copy of zkm_tpu_torch/iop/challenger.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Duplex-sponge Fiat-Shamir challenger (Poseidon, overwrite mode).

Copy of `zkm_tpu/iop/challenger.py` (plonky2's `Challenger`: one
challenger threads the whole AllProof; `compact()` snapshots the
12-element state between tables).

Host-side sequential object on python ints (canonical u64); the
permutation is the host `permute_host`.  The port always runs the
transcript here, as the reference does on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..hash import poseidon as ps

RATE = ps.SPONGE_RATE      # 8
WIDTH = ps.SPONGE_WIDTH    # 12


def _permute_host(state: List[int]) -> List[int]:
    return ps.permute_host(state)


class Challenger:
    def __init__(self, state: Sequence[int] = None):
        self.state = list(state) if state is not None else [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    # -- observe ------------------------------------------------------------

    def observe_element(self, e: int):
        assert 0 <= e < gl.P
        self.output_buffer.clear()
        self.input_buffer.append(e)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_elements(self, es):
        for e in es:
            self.observe_element(int(e))

    def observe_extension(self, e: Tuple[int, int]):
        self.observe_element(e[0])
        self.observe_element(e[1])

    def observe_cap(self, cap_u64: np.ndarray):
        """cap: (2^cap_height, 4) u64 array."""
        for row in np.asarray(cap_u64):
            self.observe_elements(row)

    # -- squeeze ------------------------------------------------------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> Tuple[int, int]:
        c = self.get_n_challenges(2)
        return (c[0], c[1])

    # -- state management ---------------------------------------------------

    def compact(self) -> List[int]:
        """Flush pending inputs and return the raw 12-element sponge state."""
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.state)

    def clone(self) -> "Challenger":
        c = Challenger(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = _permute_host(self.state)
        self.output_buffer = list(self.state[:RATE])
