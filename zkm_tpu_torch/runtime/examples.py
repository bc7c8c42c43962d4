"""Example guest programs, assembled with the guest SDK (copy of
zkm_tpu/runtime/examples.py, with `build_full_guest` from
tests/test_full_system.py and the workload `build_hash_guest`).

Reference analogs: prover/examples/{sha2-rust, keccak, sha2-composition}
guests.  Each builder returns raw program bytes for `State` /
`split_prog_into_segs`; hosts feed inputs via the hint stream and read
committed public values from the output stream.
"""

from __future__ import annotations

import struct

import numpy as np

from .asm import Asm
from . import guest

SHA256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

W_PTR = 0x2000        # message schedule buffer (64 words)
H_PTR = 0x3000        # hash state (8 words)
IN_PTR = 0x2000       # input lands directly in w[0..8]


def build_sha2_guest() -> bytes:
    """SHA-256 of a 32-byte hint input via the extend/compress syscalls
    (the sha2-rust example's core loop, single block).

    Reads 32 bytes into w[0..8], applies the one-block SHA padding
    (0x80... ‖ bit length), runs extend+compress against the standard IV,
    and commits the 32-byte digest."""
    a = Asm()
    # read input: hint_len -> a1, hint_read(IN_PTR, len)
    guest.hint_len(a)
    a.move("a1", "v0")
    a.li("a0", IN_PTR)
    guest.hint_read(a)

    # single-block padding for a 32-byte message
    a.li("t0", 0x80000000)
    a.li("t1", W_PTR)
    a.sw("t0", 32, "t1")               # w[8] = 0x80000000
    for i in range(9, 15):
        a.sw("zero", 4 * i, "t1")      # w[9..14] = 0
    a.li("t0", 32 * 8)
    a.sw("t0", 60, "t1")               # w[15] = bit length

    # initial state
    a.li("t1", H_PTR)
    for i, iv in enumerate(SHA256_IV):
        a.li("t0", iv)
        a.sw("t0", 4 * i, "t1")

    guest.sha_extend(a, W_PTR)
    guest.sha_compress(a, W_PTR, H_PTR)
    guest.commit(a, H_PTR, 32)
    guest.halt(a, 0)
    return a.assemble()


def build_keccak_guest(nbytes: int = 32) -> bytes:
    """keccak256 of an nbytes hint input (word-aligned), committing the
    digest — the keccak example guest."""
    assert nbytes % 4 == 0
    a = Asm()
    guest.hint_len(a)
    a.move("a1", "v0")
    a.li("a0", IN_PTR)
    guest.hint_read(a)
    guest.keccak(a, IN_PTR, nbytes, H_PTR)
    guest.commit(a, H_PTR, 32)
    guest.halt(a, 0)
    return a.assemble()


FULL_W_PTR, FULL_H_PTR = 0x1000, 0x1400
FULL_K_IN, FULL_K_OUT = 0x2000, 0x2400


def build_full_guest() -> bytes:
    """A guest touching every table family: arithmetic (add), logic
    (and/or/xor), memory (sw/lw), sha_extend + sha_compress, keccak, and
    the poseidon sponge chain via bootstrap/exit page hashing.  The same
    SDK calls as zkm_tpu's tests/test_full_system.py:build_full_guest, so
    the same bytes."""
    a = Asm()
    a.li("t0", 5)
    a.li("t1", 10)
    a.add("t2", "t0", "t1")
    a.and_("t3", "t0", "t1")
    a.or_("t4", "t0", "t1")
    a.xor("t5", "t2", "t4")
    a.sw("t2", 0x3000, "zero")
    a.lw("t6", 0x3000, "zero")
    guest.sha_extend(a, FULL_W_PTR)
    guest.sha_compress(a, FULL_W_PTR, FULL_H_PTR)
    guest.keccak(a, FULL_K_IN, 32, FULL_K_OUT)
    guest.halt(a, 0)
    return a.assemble()


HASH_IN_PTR = 0x10000     # the hint input; also the SHA-256 block w[0..16]
HASH_H_PTR = 0x20000      # SHA-256 state (8 words)
HASH_K_OUT = 0x20400      # keccak digest (8 words)


def build_hash_guest(keccak_calls: int = 12, keccak_bytes: int = 4000,
                     sha_blocks: int = 128) -> bytes:
    """A hash-heavy workload, not a counterpart of a zkm_tpu example: it
    fills the Keccak and SHA tables of one segment at real heights.

    Reads a hint input of at least max(keccak_bytes, 64) bytes to
    HASH_IN_PTR, runs `keccak_calls` keccak256s of its first keccak_bytes
    (word-aligned; ceil((keccak_bytes + 1) / 136) permutations each),
    then chains `sha_blocks` SHA-256 compressions of the block at
    HASH_IN_PTR (its first 64 bytes as w[0..16], extended in place) from
    the standard IV, and commits the SHA-256 state and the keccak digest.
    Only SDK calls that zkm_tpu's guest SDK has too, in two counted
    loops."""
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


def hash_guest_input(nbytes: int = 4000, seed: int = 0) -> bytes:
    """build_hash_guest's hint input: nbytes bytes drawn from `seed`."""
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def build_fib_guest(n: int) -> bytes:
    """fib(n) mod 2^32, committed as one word — a pure-CPU guest."""
    a = Asm()
    a.li("t0", 0)                      # f0
    a.li("t1", 1)                      # f1
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


def build_composition_guest(claim_addr: int = 0x4000) -> bytes:
    """Reads a 32-byte claim digest from the hint stream and calls
    sys_verify on it (the sha2-composition guest's core)."""
    a = Asm()
    guest.hint_len(a)
    a.move("a1", "v0")
    a.li("a0", claim_addr)
    guest.hint_read(a)
    guest.verify(a, claim_addr)
    guest.halt(a, 0)
    return a.assemble()


def build_memalloc_guest(n_blocks: int = 8, block_words: int = 64) -> bytes:
    """Memory-table-heavy guest (BASELINE.md's mem-alloc-vec-style
    workload; reference analog prover/examples mem-intensive guests):
    mmap a heap region (syscall 4090), write a striding pattern over
    n_blocks * block_words words, read it back XOR-accumulating, and
    commit the 4-byte accumulator.  Exercises mmap/brk, wide address
    ranges (memory-table fill_gaps), and lw/sw pressure."""
    a = Asm()
    total = n_blocks * block_words
    # v0=4090 (mmap) at an explicit address: raw (non-ELF) states start
    # with heap=0, and a kernel-placed mapping at 0 would overlap the
    # program text (ELF-loaded guests get a real heap from load_elf).
    a.li("a0", 0x100000)
    a.li("a1", total * 4)
    a.li("v0", 4090)
    a.syscall()
    a.move("s0", "v0")                 # base
    # write pass: mem[i] = i * 2654435761 (Knuth hash stride)
    a.li("t0", 0)                      # i
    a.li("t1", total)
    a.li("t2", 0x9E3779B1 & 0xFFFFFFFF)
    a.label("wloop")
    a.multu("t0", "t2")
    a.mflo("t3")
    a.sll("t4", "t0", 2)
    a.addu("t4", "s0", "t4")
    a.sw("t3", 0, "t4")
    a.addiu("t0", "t0", 1)
    a.bne("t0", "t1", "wloop")
    a.nop()
    # read pass: acc ^= mem[i]
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


def guest_elf(prog: bytes) -> bytes:
    """Raw program bytes as a 32-bit big-endian MIPS ELF: one PT_LOAD at
    address 0 (where the assembler places a program), entry 0, no
    sections.  It is what the ELF entry points take
    (`emulator.utils.load_elf_with_patch`, `host.prove_elf`, the CLI);
    they also set up the stack, so its segments are not those of the raw
    program loaded at 0."""
    data_off = 0x100
    header = b"\x7fELF" + bytes([1, 2, 1]) + bytes(9) + struct.pack(
        ">HHIIIIIHHHHHH", 2, 8, 1, 0, 52, 0, 0, 52, 32, 1, 40, 0, 0)
    phdr = struct.pack(">8I", 1, data_off, 0, 0, len(prog), len(prog), 5,
                       0x1000)
    return header + phdr + bytes(data_off - 84) + prog
