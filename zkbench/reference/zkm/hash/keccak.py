# Frozen copy of zkm_tpu_torch/hash/keccak.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Keccak-256 (Ethereum-style padding 0x01) host implementation.

Copy of zkm_tpu/hash/keccak.py: the `keccak-hash` crate of the emulator's
KECCAK syscall (zkMIPS emulator/src/state.rs:717-737), used by the
preimage syscall and the guest `io::keccak` precompile.
"""

from __future__ import annotations

from typing import List

_ROUND_CONSTANTS = []
_r = 1
for _ in range(24):
    rc = 0
    for j in range(7):
        _r = ((_r << 1) ^ ((_r >> 7) * 0x71)) & 0xFF
        if _r & 2:
            rc ^= 1 << ((1 << j) - 1)
    _ROUND_CONSTANTS.append(rc)

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f(state: List[int]) -> List[int]:
    """keccak-f[1600] on 25 u64 lanes, A[x + 5y] layout."""
    a = list(state)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    a[x + 5 * y], _ROTATIONS[x][y])
        # chi
        a = [(b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & _M64)
                      & b[(i % 5 + 2) % 5 + 5 * (i // 5)]))
             for i in range(25)]
        # iota
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136
    state = [0] * 25
    padded = bytearray(data)
    pad_len = rate - (len(data) % rate)
    padded.extend(bytes(pad_len))
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[i * 8:(i + 1) * 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
