"""Example guest programs, assembled with the guest SDK (copy of
zkm_tpu/runtime/examples.py).

Reference analogs: prover/examples/{sha2-rust, keccak, sha2-composition}
guests.  Each builder returns raw program bytes for `State` /
`split_prog_into_segs`; hosts feed inputs via the hint stream and read
committed public values from the output stream.
"""

from __future__ import annotations

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
