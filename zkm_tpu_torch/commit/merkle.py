"""Merkle tree with cap over Poseidon digests, batched on the device.

Counterpart of `zkm_tpu/commit/merkle.py`.  Leaves are rows of field
elements; leaf digest = `hash_or_noop(row)`; interior nodes =
`two_to_one(left, right)`; the tree stops at 2^cap_height nodes (the cap),
which is what the challenger observes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..convert import to_u64
from ..hash import poseidon as ps


@dataclass
class MerkleTree:
    """levels[0] = leaf digests (L, 4); levels[k] has L/2^k rows; the last
    level is the cap (2^cap_height, 4)."""
    levels: List[torch.Tensor]
    cap_height: int

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    def open_batch(self, indices) -> List[List[np.ndarray]]:
        """Merkle paths for many leaves, leaf to cap: [per index: [sibling
        u64 (4,) ...]].  Gathered on the device, fetched in one copy.  A
        cap-sized tree (2^cap_height leaves: the leaf digests are the cap)
        has empty paths."""
        if len(self.levels) == 1:
            return [[] for _ in indices]
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.cap.device)
        sibs = []
        for level in self.levels[:-1]:
            sibs.append(level.index_select(0, idx ^ 1))
            idx = idx >> 1
        arr = to_u64(torch.stack(sibs))                  # (levels, Q, 4)
        return [list(arr[:, q]) for q in range(len(indices))]


def compress_level(cur: torch.Tensor) -> torch.Tensor:
    """(2L, 4) digests -> (L, 4): two_to_one of each adjacent pair."""
    return ps.two_to_one(cur[0::2], cur[1::2])


def build_merkle_tree(leaves: torch.Tensor, cap_height: int) -> MerkleTree:
    """leaves: (L, W) field elements; L a power of two >= 2^cap_height."""
    n = leaves.shape[0]
    assert n & (n - 1) == 0 and n >= (1 << cap_height)
    levels = [ps.hash_or_noop(leaves)]
    while levels[-1].shape[0] > (1 << cap_height):
        levels.append(compress_level(levels[-1]))
    return MerkleTree(levels=levels, cap_height=cap_height)
