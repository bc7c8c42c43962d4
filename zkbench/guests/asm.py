# Frozen copy of zkm_tpu_torch/runtime/asm.py at commit 8cde39b, the
# benchmark's own guest SDK. Verbatim below this header.
"""Minimal MIPS32 assembler for guest programs.

Copy of zkm_tpu/runtime/asm.py.  zkMIPS ships Rust/Go guest SDKs compiled
with a MIPS toolchain (runtime/entrypoint, go-runtime); this guest SDK
needs none: a small two-pass assembler over the instruction subset the
emulator implements (zkMIPS emulator/src/state.rs decode), with labels,
`li` pseudo-ops and raw `.word`/`.bytes` data.

Usage:
    a = Asm()
    a.label("loop"); a.addiu("t0", "t0", 1)
    a.bne("t0", "t1", "loop"); a.nop()
    program_bytes = a.assemble()
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

REGS = {
    "zero": 0, "at": 1, "v0": 2, "v1": 3,
    "a0": 4, "a1": 5, "a2": 6, "a3": 7,
    "t0": 8, "t1": 9, "t2": 10, "t3": 11, "t4": 12, "t5": 13,
    "t6": 14, "t7": 15,
    "s0": 16, "s1": 17, "s2": 18, "s3": 19, "s4": 20, "s5": 21,
    "s6": 22, "s7": 23,
    "t8": 24, "t9": 25, "k0": 26, "k1": 27,
    "gp": 28, "sp": 29, "fp": 30, "ra": 31,
}


def _r(name: Union[str, int]) -> int:
    if isinstance(name, int):
        return name
    return REGS[name]


def _u16(imm: int) -> int:
    return imm & 0xFFFF


class Asm:
    def __init__(self, base: int = 0):
        self.base = base
        self.items: List[Tuple] = []     # ("insn", encoder) | ("word", v)
        self.labels: Dict[str, int] = {}

    # -- layout --------------------------------------------------------------

    def _pc(self) -> int:
        return self.base + 4 * len(self.items)

    def label(self, name: str):
        assert name not in self.labels, f"duplicate label {name}"
        self.labels[name] = self._pc()

    def word(self, v: int):
        self.items.append(("word", v & 0xFFFFFFFF))

    def words(self, vs):
        for v in vs:
            self.word(v)

    def _emit(self, enc):
        """enc: int or callable(labels, pc) -> int."""
        self.items.append(("insn", enc))

    def assemble(self) -> bytes:
        out = bytearray()
        for i, (kind, v) in enumerate(self.items):
            pc = self.base + 4 * i
            word = v(self.labels, pc) if callable(v) else v
            out += int(word).to_bytes(4, "big")
        return bytes(out)

    # -- encodings -----------------------------------------------------------

    def _rtype(self, func, rd, rs, rt, shamt=0, opcode=0):
        self._emit((opcode << 26) | (_r(rs) << 21) | (_r(rt) << 16)
                   | (_r(rd) << 11) | (shamt << 6) | func)

    def _itype(self, opcode, rt, rs, imm):
        if isinstance(imm, str):
            def enc(labels, pc, o=opcode, t=_r(rt), s=_r(rs), lbl=imm):
                off = (labels[lbl] - (pc + 4)) >> 2
                return (o << 26) | (s << 21) | (t << 16) | _u16(off)
            self._emit(enc)
        else:
            self._emit((opcode << 26) | (_r(rs) << 21) | (_r(rt) << 16)
                       | _u16(imm))

    # arithmetic / logic
    def addu(self, rd, rs, rt): self._rtype(0x21, rd, rs, rt)
    def add(self, rd, rs, rt): self._rtype(0x20, rd, rs, rt)
    def subu(self, rd, rs, rt): self._rtype(0x23, rd, rs, rt)
    def sub(self, rd, rs, rt): self._rtype(0x22, rd, rs, rt)
    def and_(self, rd, rs, rt): self._rtype(0x24, rd, rs, rt)
    def or_(self, rd, rs, rt): self._rtype(0x25, rd, rs, rt)
    def xor(self, rd, rs, rt): self._rtype(0x26, rd, rs, rt)
    def nor(self, rd, rs, rt): self._rtype(0x27, rd, rs, rt)
    def slt(self, rd, rs, rt): self._rtype(0x2A, rd, rs, rt)
    def sltu(self, rd, rs, rt): self._rtype(0x2B, rd, rs, rt)
    def sll(self, rd, rt, sa): self._rtype(0x00, rd, "zero", rt, sa)
    def srl(self, rd, rt, sa): self._rtype(0x02, rd, "zero", rt, sa)
    def sra(self, rd, rt, sa): self._rtype(0x03, rd, "zero", rt, sa)
    def sllv(self, rd, rt, rs): self._rtype(0x04, rd, rs, rt)
    def srlv(self, rd, rt, rs): self._rtype(0x06, rd, rs, rt)
    def mult(self, rs, rt): self._rtype(0x18, "zero", rs, rt)
    def multu(self, rs, rt): self._rtype(0x19, "zero", rs, rt)
    def div(self, rs, rt): self._rtype(0x1A, "zero", rs, rt)
    def divu(self, rs, rt): self._rtype(0x1B, "zero", rs, rt)
    def mfhi(self, rd): self._rtype(0x10, rd, "zero", "zero")
    def mflo(self, rd): self._rtype(0x12, rd, "zero", "zero")

    def addiu(self, rt, rs, imm): self._itype(0x09, rt, rs, imm)
    def addi(self, rt, rs, imm): self._itype(0x08, rt, rs, imm)
    def andi(self, rt, rs, imm): self._itype(0x0C, rt, rs, imm)
    def ori(self, rt, rs, imm): self._itype(0x0D, rt, rs, imm)
    def xori(self, rt, rs, imm): self._itype(0x0E, rt, rs, imm)
    def slti(self, rt, rs, imm): self._itype(0x0A, rt, rs, imm)
    def sltiu(self, rt, rs, imm): self._itype(0x0B, rt, rs, imm)
    def lui(self, rt, imm): self._itype(0x0F, rt, "zero", imm)

    # memory
    def lw(self, rt, off, base): self._itype(0x23, rt, base, off)
    def sw(self, rt, off, base): self._itype(0x2B, rt, base, off)
    def lb(self, rt, off, base): self._itype(0x20, rt, base, off)
    def lbu(self, rt, off, base): self._itype(0x24, rt, base, off)
    def lh(self, rt, off, base): self._itype(0x21, rt, base, off)
    def lhu(self, rt, off, base): self._itype(0x25, rt, base, off)
    def sb(self, rt, off, base): self._itype(0x28, rt, base, off)
    def sh(self, rt, off, base): self._itype(0x29, rt, base, off)

    # control flow (branches take a label; caller supplies the delay slot)
    def beq(self, rs, rt, target): self._itype(0x04, rt, rs, target)
    def bne(self, rs, rt, target): self._itype(0x05, rt, rs, target)
    def blez(self, rs, target): self._itype(0x06, "zero", rs, target)
    def bgtz(self, rs, target): self._itype(0x07, "zero", rs, target)

    def j(self, target):
        def enc(labels, pc, lbl=target):
            return (0x02 << 26) | ((labels[lbl] >> 2) & 0x3FFFFFF)
        self._emit(enc)

    def jal(self, target):
        def enc(labels, pc, lbl=target):
            return (0x03 << 26) | ((labels[lbl] >> 2) & 0x3FFFFFF)
        self._emit(enc)

    def jr(self, rs): self._rtype(0x08, "zero", rs, "zero")
    def syscall(self): self._emit(0x0000000C)
    def nop(self): self._emit(0x00000000)

    # pseudo-ops
    def li(self, rt, value: int):
        value &= 0xFFFFFFFF
        hi, lo = value >> 16, value & 0xFFFF
        if hi:
            self.lui(rt, hi)
            if lo:
                self.ori(rt, rt, lo)
        else:
            self.ori(rt, "zero", lo)

    def move(self, rd, rs):
        self.addu(rd, rs, "zero")
