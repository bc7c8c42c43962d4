# Frozen copy of zkm_tpu_torch/runtime/guest.py at commit 8cde39b, the
# benchmark's own guest SDK. Verbatim below this header.
"""Guest-side syscall ABI helpers (copy of zkm_tpu/runtime/guest.py): the
analog of zkMIPS `runtime/precompiles/src/io.rs` + `runtime/entrypoint`
syscall stubs.

Reference syscall numbers (runtime/entrypoint/src/syscalls/mod.rs:17-42,
emulator/src/state.rs handle_syscall):
  HALT (exit_group)  4246
  WRITE              4004   (fd 3 = public-values commit, fd 4 = hint)
  HINT_LEN           0xF0
  HINT_READ          0xF1
  VERIFY             0xF2
  KECCAK             0x010109
  SHA_EXTEND         0x300105
  SHA_COMPRESS       0x010106

Each helper emits the register setup + `syscall` into an `Asm`; guests
compose them with ordinary instructions.  See runtime/examples.py
for complete guests (sha2 / keccak / composition).
"""

from __future__ import annotations

from .asm import Asm

SYS_HALT = 4246
SYS_WRITE = 4004
SYS_HINT_LEN = 0xF0
SYS_HINT_READ = 0xF1
SYS_VERIFY = 0xF2
SYS_KECCAK = 0x010109
SYS_SHA_EXTEND = 0x300105
SYS_SHA_COMPRESS = 0x010106

FD_PUBLIC_VALUES = 3
FD_HINT = 4


def halt(a: Asm, code: int = 0):
    """exit_group(code) (entrypoint syscall_halt)."""
    a.li("v0", SYS_HALT)
    a.li("a0", code)
    a.syscall()


def hint_len(a: Asm):
    """v0 <- byte length of the next input vector (io::read step 1)."""
    a.li("v0", SYS_HINT_LEN)
    a.syscall()


def hint_read(a: Asm, addr_reg: str = "a0", len_reg: str = "a1"):
    """Read the next input vector to [addr_reg] (word-aligned buffer;
    length in len_reg).  io::read_vec's syscall_hint_read."""
    if addr_reg != "a0":
        a.move("a0", addr_reg)
    if len_reg != "a1":
        a.move("a1", len_reg)
    a.li("v0", SYS_HINT_READ)
    a.syscall()


def commit(a: Asm, addr: int, nbytes: int):
    """write(fd=3, addr, nbytes): commit public values (io::commit)."""
    a.li("v0", SYS_WRITE)
    a.li("a0", FD_PUBLIC_VALUES)
    a.li("a1", addr)
    a.li("a2", nbytes)
    a.syscall()


def keccak(a: Asm, data_addr: int, nbytes: int, out_addr: int):
    """keccak256 of the (pre-padded, word-aligned) buffer (io::keccak)."""
    a.li("v0", SYS_KECCAK)
    a.li("a0", data_addr)
    a.li("a1", nbytes)
    a.li("a2", out_addr)
    a.syscall()


def sha_extend(a: Asm, w_ptr: int):
    """SHA-256 message schedule: extends w[0..16] at w_ptr to w[0..64]."""
    a.li("v0", SYS_SHA_EXTEND)
    a.li("a0", w_ptr)
    a.li("a1", 0)
    a.syscall()


def sha_compress(a: Asm, w_ptr: int, h_ptr: int):
    """SHA-256 compression: folds w[0..64] at w_ptr into the state at
    h_ptr (h_ptr gets state + compressed, the standard Davies-Meyer
    add)."""
    a.li("v0", SYS_SHA_COMPRESS)
    a.li("a0", w_ptr)
    a.li("a1", h_ptr)
    a.syscall()


def verify(a: Asm, claim_addr: int):
    """sys_verify(claim_digest @ claim_addr, 32) — proof composition
    (io::verify)."""
    a.li("v0", SYS_VERIFY)
    a.li("a1", claim_addr)
    a.li("a2", 32)
    a.syscall()
