# Frozen copy of zkm_tpu_torch/hash/poseidon.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Poseidon permutation and plonky2-style hashing over Goldilocks, batched.

Counterpart of `zkm_tpu/hash/poseidon.py`: the Merkle/challenger half, and
the byte sponge of the emulator's page hashing, image ids and the sponge
table (block packing, permutation chains, `poseidon_bytes`, `hash_pages`).
A batch of states is an int64 tensor (..., 12).  `permute` runs kernel K1
(`csrc/poseidon.cu`) for a CUDA tensor and a plain version for a CPU
tensor: `_permute_plain` (torch), or for a few states the pure-Python
`permute_host`, since torch's per-operation overhead (~15 ms a
permutation on the CPU) would dominate the byte sponges' long chains of
small batches.  Every other device function here is built on `permute`;
the byte-sponge entry points take a `device` and raise without a card
unless it is "cpu".  The naive partial-round evaluation is used:
mathematically identical to plonky2's fast partial rounds.
"""

from __future__ import annotations

import operator
from functools import lru_cache

import numpy as np
import torch

from ..convert import to_u64  # frozen: `native` (K1's loader) left out
from ..device import resolve_device
from ..field import goldilocks as gl
from . import poseidon_constants as C

SPONGE_RATE = C.SPONGE_RATE       # 8 field elements
SPONGE_WIDTH = C.SPONGE_WIDTH     # 12
DIGEST = 4                        # hash output = 4 field elements
RATE_BYTES = 4 * SPONGE_RATE      # byte sponge: 8 u32 words per block
HOST_MAX_STATES = 16              # CPU batches up to this use permute_host

_RC = np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(C.N_ROUNDS, 12)
_MDS_IDX = (np.arange(12)[:, None] + np.arange(12)[None, :]) % 12
_MDS_DIAG0 = C.MDS_MATRIX_DIAG[0]   # only row 0 has a diagonal term

@lru_cache(maxsize=16)
def _tables(device: torch.device):
    return (torch.from_numpy(_RC.view(np.int64)).to(device),
            torch.from_numpy(_MDS_IDX).to(device),
            torch.tensor(C.MDS_MATRIX_CIRC, dtype=torch.int64, device=device))


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^7 (4 field muls)."""
    x2 = gl.square(x)
    x4 = gl.square(x2)
    return gl.mul(gl.mul(x4, x2), x)


def _mds_plain(s: torch.Tensor, idx: torch.Tensor,
               circ: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_i CIRC[i] * s[(r+i)%12] (+ diag at r=0): exact int64
    sums of the 32-bit halves (< 2^41 each), recombined into 128 bits."""
    lo, hi = s & gl.MASK32, gl._shr(s, 32)
    acc_lo = (lo[..., idx] * circ).sum(-1)
    acc_hi = (hi[..., idx] * circ).sum(-1)
    acc_lo[..., 0] += _MDS_DIAG0 * lo[..., 0]
    acc_hi[..., 0] += _MDS_DIAG0 * hi[..., 0]
    lo64 = acc_lo + acc_hi * (1 << 32)
    hi64 = gl._shr(acc_hi, 32) + gl._ult(lo64, acc_lo).to(torch.int64)
    return gl._reduce128(lo64, hi64)


def _permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of K1: the 30-round permutation on (..., 12)."""
    rc, idx, circ = _tables(state.device)
    h, p = C.HALF_N_FULL_ROUNDS, C.N_PARTIAL_ROUNDS
    s = state
    for r in range(C.N_ROUNDS):
        s = gl.add(s, rc[r])
        if h <= r < h + p:
            s = torch.cat([_sbox(s[..., :1]), s[..., 1:]], dim=-1)
        else:
            s = _sbox(s)
        s = _mds_plain(s, idx, circ)
    return s


def permute(state: torch.Tensor) -> torch.Tensor:
    """The full 30-round Poseidon permutation on (..., 12) states."""
    if state.dtype != torch.int64 or state.shape[-1] != SPONGE_WIDTH:
        raise ValueError(f"expected (..., 12) int64 states, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if state.is_cuda:
        return _permute_plain(state)  # frozen: plain torch, never K1
    if state.device.type == "cpu":
        if state.numel() <= HOST_MAX_STATES * SPONGE_WIDTH:
            return _permute_host_rows(state)
        return _permute_plain(state)
    raise ValueError(f"unsupported device {state.device}")


def _permute_host_rows(state: torch.Tensor) -> torch.Tensor:
    """`permute_host` on each state of a CPU tensor."""
    rows = state.reshape(-1, SPONGE_WIDTH).numpy().view(np.uint64).tolist()
    out = np.array([permute_host(r) for r in rows], dtype=np.uint64)
    return torch.from_numpy(out.view(np.int64)).view(state.shape)


# ---------------------------------------------------------------------------
# plonky2-style hashing (overwrite-mode sponge, no padding).
# ---------------------------------------------------------------------------

# frozen: left out, as only the prover uses them: hash_n_to_m_no_pad,
# hash_no_pad, hash_or_noop, two_to_one, chain_states, sponge_chains_u64.


# ---------------------------------------------------------------------------
# Byte sponge (pad10*1 over 32-byte rate blocks, LE u32 words; zkMIPS
# emulator/src/memory.rs:43-79).
# ---------------------------------------------------------------------------

def bytes_to_rate_blocks(data: bytes) -> np.ndarray:
    """Pad10*1 and pack into (num_blocks, 8) uint32 LE words (host-side)."""
    l = len(data)
    chunks = l // RATE_BYTES + 1
    buf = bytearray(data)
    buf.extend(b"\x00" * (chunks * RATE_BYTES - l))
    if l % RATE_BYTES == RATE_BYTES - 1:
        buf[l] = 0b10000001
    else:
        buf[l] = 1
        buf[chunks * RATE_BYTES - 1] = 0b10000000
    return np.frombuffer(bytes(buf), dtype="<u4").reshape(chunks, 8)


def _chain(blocks: np.ndarray, device) -> tuple:
    """(k, nb, 8) u32 blocks of k sponges -> (inputs, outputs), each
    (k, nb, 12) int64 tensors: permutation b's input (block b's words in
    the rate, the capacity carried) and its output.  One `permute` per
    block index, batched over the k sponges."""
    k, nb, _ = blocks.shape
    state = torch.zeros((k, SPONGE_WIDTH), dtype=torch.int64, device=device)
    words = torch.from_numpy(blocks.astype(np.int64)).to(device)
    inputs, outputs = [], []
    for b in range(nb):
        state = torch.cat([words[:, b], state[:, SPONGE_RATE:]], 1)
        inputs.append(state)
        state = permute(state)
        outputs.append(state)
    return torch.stack(inputs, 1), torch.stack(outputs, 1)


def sponge_chain_states(blocks: np.ndarray, device=None) -> tuple:
    """(..., nb, 8) u32 blocks -> (inputs (..., nb, 12), final (..., 12)),
    int64 tensors on `device`: `inputs[..., b, :]` is the permutation
    INPUT of block b (the rate words written, the capacity carried), what
    the Poseidon table's witness rows record; `final` is the last
    permutation's output (digest = final[..., :DIGEST]).  Batched over the
    leading axes, so all page sponges of a level take one launch per block
    index."""
    blocks = np.asarray(blocks, dtype=np.uint32)
    lead, nb = blocks.shape[:-2], blocks.shape[-2]
    inputs, outputs = _chain(blocks.reshape(-1, nb, SPONGE_RATE),
                             resolve_device(device))
    return (inputs.reshape(lead + (nb, SPONGE_WIDTH)),
            outputs[:, -1].reshape(lead + (SPONGE_WIDTH,)))


def absorb_rate_blocks(blocks: np.ndarray, device=None) -> torch.Tensor:
    """(..., nb, 8) u32 blocks -> (..., 4) digests (int64 on `device`):
    overwrite-mode absorb of each block, a permutation after each."""
    return sponge_chain_states(blocks, device)[1][..., :DIGEST]


def poseidon_bytes(data: bytes, device=None) -> np.ndarray:
    """Byte sponge (pad10*1) of `data` -> 4 u64 digest words."""
    return to_u64(absorb_rate_blocks(bytes_to_rate_blocks(data), device))


def hash_pages(pages_u32: np.ndarray, device=None) -> np.ndarray:
    """(npages, 1024) u32 LE words -> (npages, 4) u64 page hashes.  A
    4096-byte page is a multiple of the rate, so pad10*1 appends one block
    with first byte 0x01 and last byte 0x80."""
    pages = np.asarray(pages_u32, dtype=np.uint32).reshape(-1, 1024)
    n = pages.shape[0]
    pad = np.zeros((n, 1, SPONGE_RATE), dtype=np.uint32)
    pad[:, 0, 0] = 1
    pad[:, 0, 7] = 0x80 << 24      # the block's last byte (LE)
    blocks = np.concatenate([pages.reshape(n, 128, SPONGE_RATE), pad], 1)
    return to_u64(absorb_rate_blocks(blocks, device))


# ---------------------------------------------------------------------------
# Pure-python permutation (host transcript path), copied from the reference.
# ---------------------------------------------------------------------------

_P = gl.P
_RC_INT = [[int(x) for x in row] for row in _RC]
_FULL = [r < C.HALF_N_FULL_ROUNDS or
         r >= C.HALF_N_FULL_ROUNDS + C.N_PARTIAL_ROUNDS
         for r in range(C.N_ROUNDS)]
# out[row] = sum_j CIRC[(j - row) % 12] * s[j], plus DIAG0 * s[0] at row 0
_MDS_ROWS_INT = [[C.MDS_MATRIX_CIRC[(j - row) % 12] for j in range(12)]
                 for row in range(12)]
_MDS_ROWS_INT[0][0] += C.MDS_MATRIX_DIAG[0]


def permute_host(state):
    """[12 ints] -> [12 ints]; same permutation as `permute`."""
    s = [int(x) for x in state]
    for rc, full in zip(_RC_INT, _FULL):
        s = [(v + c) % _P for v, c in zip(s, rc)]
        if full:
            s = [pow(v, 7, _P) for v in s]
        else:
            s[0] = pow(s[0], 7, _P)
        s = [sum(map(operator.mul, row, s)) % _P for row in _MDS_ROWS_INT]
    return s


def hash_no_pad_host(values):
    """[ints] -> 4-int digest (plonky2 hash_n_to_hash_no_pad, host)."""
    state = [0] * SPONGE_WIDTH
    vals = [int(v) for v in values]
    for start in range(0, len(vals), SPONGE_RATE):
        chunk = vals[start:start + SPONGE_RATE]
        state[:len(chunk)] = chunk
        state = permute_host(state)
    return state[:DIGEST]


def hash_or_noop_host(values):
    vals = [int(v) for v in values]
    if len(vals) <= DIGEST:
        return vals + [0] * (DIGEST - len(vals))
    return hash_no_pad_host(vals)


def two_to_one_host(left, right):
    state = [int(x) for x in left] + [int(x) for x in right] + [0, 0, 0, 0]
    return permute_host(state)[:DIGEST]
