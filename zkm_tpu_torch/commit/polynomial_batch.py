"""Batched polynomial commitment: iNTT -> coset LDE -> Merkle cap.

Counterpart of `zkm_tpu/commit/polynomial_batch.py` (plonky2's
`PolynomialBatch::from_values`).  Conventions, bit-exact with the
reference:
  * the LDE is evaluated on the coset g*H (g = 7) at rate 2^rate_bits;
  * committed leaves are the transposed LDE rows in bit-reversed point
    order: leaf i is the evaluation point g * omega^{rev(i)};
  * FRI query index i addresses leaf i.

Built over a tp mesh (`mesh=`), a rank holds a column shard of the
coefficients (`col_counts` columns per rank) and a contiguous block of
the bit-reversed leaves (all columns): its columns' LDE goes to the
ranks that hold each block in one all_to_all, and the Merkle tree is
built as `merkle.build_merkle_tree` says.  The cap is the one-card cap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..convert import to_u64
from ..device import resolve_device
from ..field import ntt
from ..parallel.comm import Comm, tp_group
from .merkle import MerkleTree, build_merkle_tree


def _leaves(coeffs: torch.Tensor, rate_bits: int, comm=None,
            col_counts=None) -> torch.Tensor:
    """(C, N) coefficients -> (N << rate_bits, C) bit-reversed LDE rows;
    over a tp group, this rank's column shard -> its block of the rows."""
    log_m = coeffs.shape[-1].bit_length() - 1 + rate_bits
    lde_nat = ntt.lde(coeffs, rate_bits)                       # (C, M)
    rev = ntt.bit_reverse_tensor(log_m, coeffs.device)
    if comm is None:
        return lde_nat.t().index_select(0, rev)               # (M, C)
    block = comm.cols_to_rows([(lde_nat, col_counts)],
                              rev.view(comm.size, -1))        # (C, M/tp)
    return block.t().contiguous()


@dataclass
class PolynomialBatch:
    coeffs: Optional[torch.Tensor]      # (C, N) coefficient form
    leaves: Optional[torch.Tensor]      # (N << rate_bits, C), bit-reversed
    tree: Optional[MerkleTree]
    rate_bits: int
    cap_height: int
    comm: Optional[Comm] = None         # the tp group, when sharded
    col_counts: Optional[List[int]] = None

    @classmethod
    def from_values(cls, values: torch.Tensor, rate_bits: int,
                    cap_height: int, device=None, mesh=None,
                    col_counts=None) -> "PolynomialBatch":
        """values: (C, N) evaluations over the size-N subgroup (over a
        mesh: this rank's column shard).  Runs on the card unless
        device='cpu' (over a mesh: on the mesh's device)."""
        values = values.to(mesh.device if mesh is not None
                           else resolve_device(device))
        return cls.from_coeffs(ntt.intt(values), rate_bits, cap_height,
                               device=values.device, mesh=mesh,
                               col_counts=col_counts)

    @classmethod
    def from_coeffs(cls, coeffs: torch.Tensor, rate_bits: int,
                    cap_height: int, device=None, mesh=None,
                    col_counts=None) -> "PolynomialBatch":
        """Over a tp mesh, coeffs is this rank's column shard and
        col_counts every rank's column count."""
        comm = tp_group(mesh)
        coeffs = coeffs.to(mesh.device if mesh is not None
                           else resolve_device(device))
        leaves = _leaves(coeffs, rate_bits, comm, col_counts)
        return cls(coeffs=coeffs, leaves=leaves,
                   tree=build_merkle_tree(leaves, cap_height, comm),
                   rate_bits=rate_bits, cap_height=cap_height, comm=comm,
                   col_counts=col_counts)

    @property
    def degree(self) -> int:
        return self.coeffs.shape[-1]

    @property
    def degree_bits(self) -> int:
        return self.degree.bit_length() - 1

    @property
    def num_polys(self) -> int:
        """Columns in all (over a tp group, not only this rank's)."""
        return sum(self.col_counts) if self.comm else self.coeffs.shape[0]

    @property
    def lde_size(self) -> int:
        return self.leaves.shape[0] * (self.comm.size if self.comm else 1)

    def cap_u64(self) -> np.ndarray:
        return to_u64(self.tree.cap)

    def release(self):
        """Drop the LDE leaves, tree and coefficients so the allocator can
        reclaim them once the table's proof is assembled."""
        self.coeffs = None
        self.leaves = None
        self.tree = None

    def open_rows(self, indices):
        """(rows u64 (Q, C), paths [per query: [sibling (4,) ...]]), each
        from the rank that holds it over a tp group."""
        return self.tree.open(indices, self.leaves)

