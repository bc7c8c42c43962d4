# Frozen copy of three builders of zkm_tpu_torch/runtime/examples.py at
# commit 8cde39b (build_memalloc_guest, build_hash_guest, build_fib_guest,
# hash_guest_input), the benchmark's own guests.  Changed: the constants a
# seed picks are arguments (memalloc's stride, fib's initial pair), and
# `li` is given only constants whose two halves are both nonzero, so that
# it always emits two instructions and a guest's step count is the same
# for every seed.
"""Guest programs of the benchmark's traffic, assembled with the guest SDK.

Each builder returns raw program bytes for `emulator.state.State` and
`split_prog_into_segs`; a hint input goes in through the input stream.
"""

from __future__ import annotations

import numpy as np

from . import guest
from .asm import Asm

SHA256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

H_PTR = 0x3000        # where fib commits its result

HASH_IN_PTR = 0x10000     # the hint input; also the SHA-256 block w[0..16]
HASH_H_PTR = 0x20000      # SHA-256 state (8 words)
HASH_K_OUT = 0x20400      # keccak digest (8 words)


def two_halves(value: int) -> int:
    """`value` as a 32-bit constant whose halves are both nonzero (so
    `Asm.li` takes two instructions)."""
    hi, lo = (value >> 16) & 0xFFFF, value & 0xFFFF
    return ((hi or 1) << 16) | (lo or 1)


def build_memalloc_guest(n_blocks: int = 64, block_words: int = 64,
                         stride: int = 0x9E3779B1) -> bytes:
    """Memory-table-heavy guest (zkm's mem-alloc-vec example's pattern):
    mmap a heap region (syscall 4090), write mem[i] = i * stride over
    n_blocks * block_words words, read it back XOR-accumulating, and
    commit the 4-byte accumulator."""
    a = Asm()
    total = n_blocks * block_words
    a.li("a0", 0x100000)
    a.li("a1", total * 4)
    a.li("v0", 4090)
    a.syscall()
    a.move("s0", "v0")                 # base
    a.li("t0", 0)                      # i
    a.li("t1", total)
    a.li("t2", two_halves(stride))
    a.label("wloop")
    a.multu("t0", "t2")
    a.mflo("t3")
    a.sll("t4", "t0", 2)
    a.addu("t4", "s0", "t4")
    a.sw("t3", 0, "t4")
    a.addiu("t0", "t0", 1)
    a.bne("t0", "t1", "wloop")
    a.nop()
    a.li("t0", 0)
    a.li("t5", 0)                      # acc
    a.label("rloop")
    a.sll("t4", "t0", 2)
    a.addu("t4", "s0", "t4")
    a.lw("t3", 0, "t4")
    a.xor("t5", "t5", "t3")
    a.addiu("t0", "t0", 1)
    a.bne("t0", "t1", "rloop")
    a.nop()
    a.li("t6", 0x3000)
    a.sw("t5", 0, "t6")
    guest.commit(a, 0x3000, 4)
    guest.halt(a, 0)
    return a.assemble()


def build_hash_guest(keccak_calls: int = 12, keccak_bytes: int = 4000,
                     sha_blocks: int = 128) -> bytes:
    """A hash-heavy guest: reads a hint input of at least
    max(keccak_bytes, 64) bytes to HASH_IN_PTR, runs `keccak_calls`
    keccak256s of its first keccak_bytes, then chains `sha_blocks` SHA-256
    compressions of the block at HASH_IN_PTR from the standard IV, and
    commits the SHA-256 state and the keccak digest."""
    assert keccak_bytes % 4 == 0 and keccak_calls > 0 and sha_blocks > 0
    a = Asm()
    guest.hint_len(a)
    a.move("a1", "v0")
    a.li("a0", HASH_IN_PTR)
    guest.hint_read(a)

    a.li("s0", keccak_calls)
    a.label("keccak_loop")
    guest.keccak(a, HASH_IN_PTR, keccak_bytes, HASH_K_OUT)
    a.addiu("s0", "s0", -1)
    a.bgtz("s0", "keccak_loop")
    a.nop()

    a.li("t1", HASH_H_PTR)
    for i, iv in enumerate(SHA256_IV):
        a.li("t0", iv)
        a.sw("t0", 4 * i, "t1")
    a.li("s1", sha_blocks)
    a.label("sha_loop")
    guest.sha_extend(a, HASH_IN_PTR)
    guest.sha_compress(a, HASH_IN_PTR, HASH_H_PTR)
    a.addiu("s1", "s1", -1)
    a.bgtz("s1", "sha_loop")
    a.nop()

    guest.commit(a, HASH_H_PTR, 32)
    guest.commit(a, HASH_K_OUT, 32)
    guest.halt(a, 0)
    return a.assemble()


def hash_guest_input(nbytes: int, rng: np.random.Generator) -> bytes:
    """build_hash_guest's hint input: nbytes bytes drawn from `rng`."""
    return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def build_fib_guest(n: int, f0: int = 0x00010001,
                    f1: int = 0x00010002) -> bytes:
    """fib(n) mod 2^32 from the pair (f0, f1), committed as one word: a
    pure-CPU guest (zkm's fibonacci example)."""
    a = Asm()
    a.li("t0", two_halves(f0))
    a.li("t1", two_halves(f1))
    a.li("t2", n)
    a.label("loop")
    a.blez("t2", "done")
    a.nop()
    a.addu("t3", "t0", "t1")           # delay-free body
    a.move("t0", "t1")
    a.move("t1", "t3")
    a.addiu("t2", "t2", -1)
    a.j("loop")
    a.nop()
    a.label("done")
    a.li("t4", H_PTR)
    a.sw("t0", 0, "t4")
    guest.commit(a, H_PTR, 4)
    guest.halt(a, 0)
    return a.assemble()
