"""Multi-GPU proving over torch.distributed: the (dp, tp) mesh and its steps.

Counterpart of `zkm_tpu/parallel/sharding.py`.  The mesh's two axes:
  * dp: independent segments (separate proofs on disjoint tp groups);
  * tp: one segment's columns or points, split over the ranks of a group.

Every rank holds a contiguous block of the tp axis (`comm.split_counts`
columns, or M / tp points).  Where GSPMD inserted collectives from
sharding constraints, the steps here call them (`comm.Comm`):
  * commit: column-local iNTT and LDE (K2), one all_to_all to row blocks
    of the bit-reversed LDE, local leaf digests and subtrees (K1), one
    all_gather of the subtree roots for the cap;
  * quotient: the rate-1 LDE on column shards, one all_to_all to point
    blocks that carries each block's two-point next-row halo from the
    next block (wrapping at the end);
  * fold: one all_to_all, since output j needs entry i * stride + j of
    every i-block.
The results are bit-identical to the unsharded functions beside them.
A sharded step takes and returns this rank's blocks; `Mesh.local` cuts
them from a whole tensor.

`make_mesh` lays out the world of the process group that `launch.launch`
(or the caller, e.g. under torchrun) initialized: (dp, tp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..commit.merkle import build_merkle_tree
from ..commit.polynomial_batch import PolynomialBatch, _leaves
from ..device import resolve_device
from ..field import goldilocks as gl
from ..field import ntt
from ..stark.prover import quotient_domain_tables
from ..stark.vanishing_poly import eval_vanishing_scheduled
from .comm import Comm, halo_points, offsets, split_counts


@dataclass
class Mesh:
    """This rank's place in a (dp, tp) layout of the world: global rank
    = dp_index * tp + tp_index.  `tp_comm` is its tp row (one segment's
    ranks), `dp_comm` its dp column (the ranks at its tp index)."""
    dp: int
    tp: int
    dp_index: int
    tp_index: int
    device: torch.device
    tp_comm: Comm
    dp_comm: Comm

    @property
    def rank(self) -> int:
        return self.dp_index * self.tp + self.tp_index

    def dp_block(self, n: int) -> slice:
        """This rank's dp block of n segments (n divisible by dp)."""
        if n % self.dp:
            raise ValueError(f"{n} segments do not split over dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)

    def tp_block(self, n: int, even: bool = False) -> slice:
        """This rank's tp block of n columns (split_counts) or, with
        `even`, of n points (n divisible by tp)."""
        if even and n % self.tp:
            raise ValueError(f"{n} rows or points do not split over "
                             f"tp={self.tp}: heights must be divisible by tp")
        counts = split_counts(n, self.tp)
        o = offsets(counts)[self.tp_index]
        return slice(o, o + counts[self.tp_index])

    def local(self, x: torch.Tensor, axis: int, even: bool = False
              ) -> torch.Tensor:
        """This rank's block of a whole (S, ...) tensor: the dp block of
        axis 0 and the tp block of `axis`, on the mesh's device."""
        x = x[self.dp_block(x.shape[0])]
        idx = [slice(None)] * x.dim()
        idx[axis] = self.tp_block(x.shape[axis], even)
        return x[tuple(idx)].to(self.device)


def _card(rank: int, world: int, backend: str) -> int:
    n = torch.cuda.device_count()
    if backend == "nccl" and world > n:
        raise ValueError(
            f"NCCL needs one card per rank: {world} ranks, {n} card(s); "
            f"pass backend='gloo' to let ranks share a card")
    return rank % n


def make_mesh(dp: int, tp: int, backend=None, device=None) -> Mesh:
    """Lay the world's ranks out (dp, tp).  With more than one rank the
    process group must be initialized (`launch.launch` does it) and run
    `backend`.  device=None means this rank's card (rank modulo the
    cards), "cpu" the host; backend=None means NCCL on cards (which
    refuses two ranks on one card: pass backend="gloo" for that) and gloo
    on the host.  Raises unless dp * tp is the world size."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks, the "
                         f"world has {world}")
    dev = resolve_device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dev.type == "cuda":
        backend = backend or "nccl"
        card = _card(rank, world, backend)
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} cannot run on the host")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")

    def comms(groups: List[List[int]]) -> Comm:
        # every rank creates every group, in the same order
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Comm(g, ranks, backend, ranks.index(rank), dev) \
                    if len(ranks) > 1 else Comm.solo()
        return mine

    tp_comm = comms([[d * tp + t for t in range(tp)] for d in range(dp)])
    dp_comm = comms([[d * tp + t for d in range(dp)] for t in range(tp)])
    return Mesh(dp=dp, tp=tp, dp_index=rank // tp, tp_index=rank % tp,
                device=dev, tp_comm=tp_comm, dp_comm=dp_comm)


# ---------------------------------------------------------------------------
# Commit: (S, C, N) traces -> coefficients, leaf digests, caps.
# ---------------------------------------------------------------------------

def commit_step(traces: torch.Tensor, rate_bits: int, cap_height: int):
    """(S, C, N) segment traces -> (coeffs (S, C, N), leaf digests
    (S, M, 4), caps (S, 2^cap_height, 4)), M = N << rate_bits."""
    coeffs = ntt.intt(traces)
    trees = [build_merkle_tree(_leaves(c, rate_bits), cap_height)
             for c in coeffs]
    return (coeffs, torch.stack([t.levels[0] for t in trees]),
            torch.stack([t.cap for t in trees]))


def make_sharded_commit_step(mesh: Mesh, rate_bits: int = 2,
                             cap_height: int = 4):
    """commit_step on this rank's (S/dp, column shard, N) traces ->
    (its coefficient columns, its row block of the leaf digests
    (S/dp, M/tp, 4), the whole caps)."""
    comm = mesh.tp_comm

    def step(traces: torch.Tensor):
        coeffs = ntt.intt(traces)
        counts = comm.counts(traces.shape[1])
        batches = [PolynomialBatch.from_coeffs(
            c, rate_bits, cap_height, mesh=mesh, col_counts=counts)
            for c in coeffs]
        return (coeffs, torch.stack([b.tree.levels[0] for b in batches]),
                torch.stack([b.tree.cap for b in batches]))

    return step


# ---------------------------------------------------------------------------
# Quotient: constraint values over the 2N coset, points over tp.
# ---------------------------------------------------------------------------

def _vanishing(stark, full, full_next, alphas, z_last) -> torch.Tensor:
    """Stark-only constraints, alpha-combined, boundary selectors zero
    (zkm_tpu's quotient_step): (n_alphas, points)."""
    zeros = torch.zeros_like(z_last)
    return torch.stack(eval_vanishing_scheduled(
        stark, 0, (), full, full_next, [], alphas, (z_last, zeros, zeros)))


def quotient_step(stark, coeffs: torch.Tensor, alphas, degree_bits: int):
    """(S, C, N) trace coefficients -> (S, n_alphas, 2N) alpha-combined
    vanishing values on the 2N quotient coset."""
    z_last = quotient_domain_tables(degree_bits, coeffs.device)[0]
    outs = []
    for c in coeffs:
        lde = ntt.lde(c, 1)
        outs.append(_vanishing(stark, lde, torch.roll(lde, -2, dims=-1),
                               alphas, z_last))
    return torch.stack(outs)


def make_sharded_quotient_step(mesh: Mesh, stark, alphas, degree_bits: int):
    """quotient_step on this rank's (S/dp, column shard, N) coefficients
    -> its (S/dp, n_alphas, 2N/tp) block of coset points."""
    comm = mesh.tp_comm
    m = 2 << degree_bits
    blk = mesh.tp_block(m, even=True)
    z_last = quotient_domain_tables(degree_bits, mesh.device)[0][blk]

    def step(coeffs: torch.Tensor):
        counts = comm.counts(coeffs.shape[1])
        points = halo_points(m, comm.size, 2, coeffs.device)
        outs = []
        for c in coeffs:
            full = comm.cols_to_rows([(ntt.lde(c, 1), counts)], points)
            b = full.shape[-1] - 2
            outs.append(_vanishing(stark, full[:, :b], full[:, 2:],
                                   alphas, z_last))
        return torch.stack(outs)

    return step


# ---------------------------------------------------------------------------
# FRI fold: (S, M) values -> (S, M / arity), Horner over stride groups.
# ---------------------------------------------------------------------------

def _horner(groups: torch.Tensor, beta: int) -> torch.Tensor:
    """groups (..., arity, K) -> sum_i beta^i groups[..., i, :]."""
    acc = groups[..., -1, :]
    for i in reversed(range(groups.shape[-2] - 1)):
        acc = gl.add(gl.mul(acc, beta), groups[..., i, :])
    return acc


def fri_fold_step(values: torch.Tensor, beta: int, arity_bits: int = 2):
    """One FRI fold of (S, M) codeword values: out[j] = sum_i beta^i
    values[i * M/arity + j] (zkm_tpu's value-space fold)."""
    s, m = values.shape
    arity = 1 << arity_bits
    return _horner(values.reshape(s, arity, m // arity), beta % gl.P)


def make_sharded_fri_fold(mesh: Mesh, beta, arity_bits: int = 2):
    """fri_fold_step on this rank's (S/dp, M/tp) block of points -> its
    (S/dp, M/(arity tp)) block of the folded values.

    View the M points as arity * tp chunks of K = M/(arity tp): chunk
    c = i * tp + t holds entries i * stride + (t's block), so it goes to
    rank t, and rank r holds chunks r * arity .. r * arity + arity - 1.
    One all_to_all moves them (padded where arity is not a multiple of
    tp); rank t then has its i-chunks in order and folds them."""
    comm = mesh.tp_comm
    tp, me = comm.size, comm.rank
    arity = 1 << arity_bits
    # chunk indices rank r sends to rank t, and what rank t receives
    sends = [[[c for c in range(r * arity, (r + 1) * arity) if c % tp == t]
              for t in range(tp)] for r in range(tp)]
    width = max(len(x) for row in sends for x in row)

    def step(values: torch.Tensor):
        s, b = values.shape
        k = b // arity
        chunks = values.reshape(s, arity, k)
        buf = values.new_zeros((tp, s, width, k))
        for t, cs in enumerate(sends[me]):
            for j, c in enumerate(cs):
                buf[t, :, j] = chunks[:, c - me * arity]
        recv = comm.all_to_all(buf)              # [r]: rank r's chunks for me
        by_i = {}
        for r in range(tp):
            for j, c in enumerate(sends[r][me]):
                by_i[c // tp] = recv[r, :, j]
        return _horner(torch.stack([by_i[i] for i in range(arity)], 1),
                       beta % gl.P)

    return step
