"""Batched polynomial commitment: iNTT -> coset LDE -> Merkle cap.

Counterpart of `zkm_tpu/commit/polynomial_batch.py` (plonky2's
`PolynomialBatch::from_values`).  Conventions, bit-exact with the
reference:
  * the LDE is evaluated on the coset g*H (g = 7) at rate 2^rate_bits;
  * committed leaves are the transposed LDE rows in bit-reversed point
    order: leaf i is the evaluation point g * omega^{rev(i)};
  * FRI query index i addresses leaf i.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..convert import to_u64
from ..device import resolve_device
from ..field import ntt
from .merkle import MerkleTree, build_merkle_tree


def _leaves(coeffs: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """(C, N) coefficients -> (N << rate_bits, C) bit-reversed LDE rows."""
    log_m = coeffs.shape[-1].bit_length() - 1 + rate_bits
    lde_nat = ntt.lde(coeffs, rate_bits)                       # (C, M)
    rev = ntt.bit_reverse_tensor(log_m, coeffs.device)
    return lde_nat.t().index_select(0, rev)                   # (M, C)


@dataclass
class PolynomialBatch:
    coeffs: Optional[torch.Tensor]      # (C, N) coefficient form
    leaves: Optional[torch.Tensor]      # (N << rate_bits, C), bit-reversed
    tree: Optional[MerkleTree]
    rate_bits: int
    cap_height: int

    @classmethod
    def from_values(cls, values: torch.Tensor, rate_bits: int,
                    cap_height: int, device=None) -> "PolynomialBatch":
        """values: (C, N) evaluations over the size-N subgroup.  Runs on
        the card unless device='cpu'."""
        values = values.to(resolve_device(device))
        return cls.from_coeffs(ntt.intt(values), rate_bits, cap_height,
                               device=values.device)

    @classmethod
    def from_coeffs(cls, coeffs: torch.Tensor, rate_bits: int,
                    cap_height: int, device=None) -> "PolynomialBatch":
        coeffs = coeffs.to(resolve_device(device))
        leaves = _leaves(coeffs, rate_bits)
        return cls(coeffs=coeffs, leaves=leaves,
                   tree=build_merkle_tree(leaves, cap_height),
                   rate_bits=rate_bits, cap_height=cap_height)

    @property
    def degree(self) -> int:
        return self.coeffs.shape[-1]

    @property
    def degree_bits(self) -> int:
        return self.degree.bit_length() - 1

    @property
    def lde_size(self) -> int:
        return self.leaves.shape[0]

    def cap_u64(self) -> np.ndarray:
        return to_u64(self.tree.cap)

    def release(self):
        """Drop the LDE leaves, tree and coefficients so the allocator can
        reclaim them once the table's proof is assembled."""
        self.coeffs = None
        self.leaves = None
        self.tree = None

    def open_rows(self, indices):
        """(rows u64 (Q, C), paths [per query: [sibling (4,) ...]])."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.leaves.device)
        rows = to_u64(self.leaves.index_select(0, idx))
        return rows, self.tree.open_batch(indices)

