"""Collectives over one process group, and the layouts they move between.

Under JAX, GSPMD inserts the collectives of a sharded step itself; here
they are explicit.  A `Comm` wraps one `torch.distributed` group (the tp
row or the dp column of a `sharding.Mesh`) with the collectives the port
needs: `all_gather` and `all_to_all` (equal splits: callers pad) on
int64 tensors, and `all_gather_object`.  No broadcast: every rank holds
what the others would send it, down to the proof it returns.  It counts
the calls, the bytes this rank receives from the others and the seconds
spent.

With NCCL, device tensors go straight through, and a host tensor (NCCL
takes none) goes to the group's card first.  With gloo, whose CUDA
support is limited to broadcast and all_reduce (and varies by version),
a CUDA tensor is copied to host memory for the collective and back.
Both happen here and nowhere else; all computation stays on the card.

Shards are contiguous: a "column shard" of C columns over `size` ranks
holds `split_counts(C, size)[r]` columns in rank order, a "point block"
holds M / size consecutive points.  `cols_to_rows` and `rows_to_cols` move
between the two with one all_to_all each; `gather_cols` collects column
shards with one all_gather.  A group of one rank does no communication.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch


def split_counts(n: int, parts: int) -> List[int]:
    """n items over `parts` ranks, contiguous, the first n % parts ranks
    holding one more."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def offsets(counts: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += c
    return out


def tp_group(mesh) -> Optional["Comm"]:
    """A `sharding.Mesh`'s tp group, or None for no mesh or a group of
    one rank (nothing to spread)."""
    if mesh is None or mesh.tp_comm.size == 1:
        return None
    return mesh.tp_comm


def halo_points(m: int, size: int, halo: int, device) -> torch.Tensor:
    """(size, m/size + halo): block j's points and the `halo` points
    after it, wrapping at the end (the next-row view of a block)."""
    b = m // size
    return (torch.arange(size, device=device)[:, None] * b
            + torch.arange(b + halo, device=device)) % m


class Comm:
    """One group's collectives.  `ranks` are the group's global ranks in
    order; `rank` is this process's index among them; `device` is this
    rank's device (where NCCL's buffers live)."""

    def __init__(self, group, ranks: Sequence[int], backend: Optional[str],
                 rank: int, device: Optional[torch.device] = None):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.backend = backend
        self.rank = rank
        self.device = device
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    @classmethod
    def solo(cls) -> "Comm":
        return cls(None, [0], None, 0)

    def stats(self) -> Tuple[int, int, float]:
        return self.calls, self.bytes, self.seconds

    # -- the collectives -----------------------------------------------------

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """What goes to torch.distributed: contiguous, on the host under
        gloo and on this rank's card under NCCL."""
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo" else x.to(self.device)

    def _run(self, fn, x: torch.Tensor, received: int):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += received
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) on every rank -> (size, ...), rank i's at [i]."""
        if self.size == 1:
            return x.unsqueeze(0)
        import torch.distributed as dist

        def go():
            src = self._wire(x)
            out = src.new_empty((self.size,) + tuple(src.shape))
            dist.all_gather(list(out.unbind(0)), src, group=self.group)
            return out.to(x.device)
        return self._run(go, x, (self.size - 1) * x.numel() * x.element_size())

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(size, ...): [j] goes to rank j; returns (size, ...) with rank
        i's [rank] at [i]."""
        assert x.shape[0] == self.size, (tuple(x.shape), self.size)
        if self.size == 1:
            return x
        import torch.distributed as dist

        def go():
            src = self._wire(x)
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out.to(x.device)
        return self._run(go, x, (self.size - 1) * (x.numel() // self.size)
                         * x.element_size())

    def all_gather_object(self, obj) -> list:
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        t0 = time.perf_counter()
        dist.all_gather_object(out, obj, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    # -- layouts -------------------------------------------------------------

    def counts(self, n_local: int) -> List[int]:
        """Every rank's n_local, in rank order."""
        got = self.all_gather(torch.tensor([n_local], dtype=torch.int64))
        return [int(v) for v in got.flatten()]

    def cols_to_rows(self, pieces, points: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Column shards -> every column at this rank's points.

        pieces: [(x (c_r, M) this rank's columns, counts)], stacked in
        order in the result.  points: (size, K) indices of the points rank
        j receives (default: contiguous blocks of M / size); a point may
        go to several ranks (a halo).  Returns (sum of C, K)."""
        m = pieces[0][0].shape[-1]
        device = pieces[0][0].device
        if points is None:
            points = torch.arange(m, device=device).view(self.size, -1)
        send = []
        for x, counts in pieces:
            part = x[:, points]
            pad = max(counts) - x.shape[0]
            if pad:
                part = torch.cat([part, part.new_zeros(
                    (pad,) + tuple(part.shape[1:]))])
            send.append(part)
        recv = self.all_to_all(torch.cat(send).transpose(0, 1))
        out, off = [], 0
        for _, counts in pieces:
            out.extend(recv[i, off:off + c] for i, c in enumerate(counts))
            off += max(counts)
        return torch.cat(out)

    def rows_to_cols(self, x: torch.Tensor, counts: Sequence[int]
                     ) -> torch.Tensor:
        """(C, B) every column at this rank's block of points -> (c_r,
        size * B) this rank's columns at every point."""
        cmax = max(counts)
        buf = x.new_zeros((self.size, cmax, x.shape[-1]))
        for j, (o, c) in enumerate(zip(offsets(counts), counts)):
            buf[j, :c] = x[o:o + c]
        recv = self.all_to_all(buf)                   # [i]: rank i's block
        mine = counts[self.rank]
        return recv[:, :mine].transpose(0, 1).reshape(
            mine, self.size * x.shape[-1])

    def gather_cols(self, pieces) -> List[torch.Tensor]:
        """[(x (c_r, ...) this rank's column shard, counts)] -> every
        piece's whole (C, ...), with one all_gather."""
        tail = pieces[0][0].shape[1:]
        send = []
        for x, counts in pieces:
            part = x.new_zeros((max(counts),) + tuple(tail))
            part[:x.shape[0]] = x
            send.append(part)
        got = self.all_gather(torch.cat(send))
        out, off = [], 0
        for _, counts in pieces:
            out.append(torch.cat([got[i, off:off + c]
                                  for i, c in enumerate(counts)]))
            off += max(counts)
        return out

    def gather_points(self, x: torch.Tensor) -> torch.Tensor:
        """(..., B) this rank's point block -> (..., size * B)."""
        if self.size == 1:
            return x
        got = self.all_gather(x)                      # (size, ..., B)
        return torch.cat(got.unbind(0), dim=-1)
