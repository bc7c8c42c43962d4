"""Merkle tree with cap over Poseidon digests, batched on the device.

Counterpart of `zkm_tpu/commit/merkle.py`.  Leaves are rows of field
elements; leaf digest = `hash_or_noop(row)`; interior nodes =
`two_to_one(left, right)`; the tree stops at 2^cap_height nodes (the cap),
which is what the challenger observes.

Over a tp group (`comm`), each rank holds a contiguous block of the
leaves and builds its subtree up to 2^cap_height / tp nodes (one node
when the cap has fewer than tp); one all_gather of those nodes gives
every rank the same level, from which the remaining levels up to the cap
are computed on every rank.  The cap equals the one-card tree's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..convert import to_u64
from ..hash import poseidon as ps
from ..parallel.comm import Comm


@dataclass
class MerkleTree:
    """levels[0] = leaf digests (L, 4); levels[k] has L/2^k rows; the last
    level is the cap (2^cap_height, 4).  Over a tp group, `levels` are
    this rank's subtree (its block of each level) and `upper` the levels
    every rank holds, from the gathered subtree roots up to the cap."""
    levels: List[torch.Tensor]
    cap_height: int
    comm: Optional[Comm] = None
    upper: List[torch.Tensor] = field(default_factory=list)

    @property
    def cap(self) -> torch.Tensor:
        return self.upper[-1] if self.upper else self.levels[-1]

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0] * (self.comm.size if self.upper else 1)

    def open(self, indices, leaves: torch.Tensor):
        """(leaf rows u64 (Q, W), paths as `open_batch`) at global leaf
        indices; `leaves` are the tree's (this rank's block of) rows.
        Over a tp group each row and the subtree part of its path come
        from the rank that holds them, in one all_gather."""
        idx = np.asarray(indices, dtype=np.int64)
        if not self.upper:
            t = torch.as_tensor(idx, device=leaves.device)
            return to_u64(leaves.index_select(0, t)), self.open_batch(idx)
        n_local, q = leaves.shape[0], len(idx)
        local = torch.as_tensor(idx % n_local, device=leaves.device)
        parts = [leaves.index_select(0, local)]
        for k, level in enumerate(self.levels[:-1]):
            parts.append(level.index_select(0, (local >> k) ^ 1))
        got = self.comm.all_gather(torch.cat(parts, dim=1))   # (size, Q, .)
        own = torch.as_tensor(idx // n_local, device=leaves.device)
        picked = to_u64(got[own, torch.arange(q, device=leaves.device)])
        width = leaves.shape[1]
        sibs = picked[:, width:].reshape(q, -1, 4)
        k0 = len(self.levels) - 1
        tops = [to_u64(level.index_select(0, torch.as_tensor(
            ((idx >> (k0 + u)) ^ 1), device=level.device)))
            for u, level in enumerate(self.upper[:-1])]
        paths = [list(sibs[i]) + [t[i] for t in tops] for i in range(q)]
        return picked[:, :width], paths

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


def build_merkle_tree(leaves: torch.Tensor, cap_height: int,
                      comm: Optional[Comm] = None) -> MerkleTree:
    """leaves: (L, W) field elements; L a power of two >= 2^cap_height.
    With a tp group `comm` of more than one rank, leaves are this rank's
    block of L/tp rows."""
    size = comm.size if comm is not None else 1
    n = leaves.shape[0] * size
    assert n & (n - 1) == 0 and n >= (1 << cap_height), (n, cap_height)
    stop = max(1, (1 << cap_height) // size)
    levels = [ps.hash_or_noop(leaves)]
    while levels[-1].shape[0] > stop:
        levels.append(compress_level(levels[-1]))
    if size == 1:
        return MerkleTree(levels=levels, cap_height=cap_height)
    upper = [comm.all_gather(levels[-1]).reshape(-1, 4)]
    while upper[-1].shape[0] > (1 << cap_height):
        upper.append(compress_level(upper[-1]))
    return MerkleTree(levels=levels, cap_height=cap_height, comm=comm,
                      upper=upper)
