# Frozen copy of zkm_tpu_torch/emulator/state.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""MIPS32 zkVM emulator: interpreter, syscalls, segmentation.

Copy of zkm_tpu/emulator/state.py (zkMIPS emulator/src/state.rs).
Semantics are mirrored exactly (instruction behavior, branch delay slots,
syscall ABI, cycle metering, segment image ids).  The interpreter loop is
host-side scalar code (inherently sequential); with `native=True` the C++
core (`emulator/native.py`) runs it and hands every syscall back to
`mips_step`.  A `State` carries the device its memory hashes pages on
(None: the card).

Syscall numbers (state.rs:598-918): SHA_EXTEND=0x300105, SHA_COMPRESS=
0x010106, KECCAK=0x010109, HINT_LEN=0xF0, HINT_READ=0xF1, VERIFY=0xF2,
getpid/preimage=4020, mmap=4090/4210, brk=4045, clone=4120, exit_group=4246,
read=4003, write=4004 (fd3 commit / fd4 hint), fcntl=4055,
set_thread_area=4283.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .elf import parse_elf, PT_LOAD, PT_TLS, PT_MIPS_ABIFLAGS
from .memory import (Memory, INIT_SP, PAGE_SIZE, PAGE_ADDR_MASK)
from ..hash.keccak import keccak256
from ..utils.serialize import bincode_serialize

FD_STDIN, FD_STDOUT, FD_STDERR, FD_PUBLIC_VALUES, FD_HINT = 0, 1, 2, 3, 4
MIPS_EBADF = 9

REGISTERS_START = 0x81020400
PAGE_LOAD_CYCLES = 128
PAGE_HASH_CYCLES = 1
PAGE_CYCLES = PAGE_LOAD_CYCLES + PAGE_HASH_CYCLES
IMAGE_ID_CYCLES = 3
MAX_INSTRUCTION_CYCLES = PAGE_CYCLES * 6
RESERVE_CYCLES = IMAGE_ID_CYCLES + MAX_INSTRUCTION_CYCLES
SEGMENT_STEPS = 65536

M32 = 0xFFFFFFFF

SHA_COMPRESS_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

_PATCH_SYMBOLS = {
    "runtime.gcenable", "runtime.init.5", "runtime.main.func1",
    "runtime.deductSweepCredit", "runtime.(*gcControllerState).commit",
    "github.com/prometheus/client_golang/prometheus.init",
    "github.com/prometheus/client_golang/prometheus.init.0",
    "github.com/prometheus/procfs.init",
    "github.com/prometheus/common/model.init",
    "github.com/prometheus/client_model/go.init",
    "github.com/prometheus/client_model/go.init.0",
    "github.com/prometheus/client_model/go.init.1",
    "flag.init", "runtime.check", "runtime.checkfds",
    "_dl_discover_osversion",
}


def sign_extension(dat: int, idx: int) -> int:
    """Sign-extend the low `idx` bits of dat to 32 bits."""
    dat &= M32
    is_signed = (dat >> (idx - 1)) & 1
    signed = ((1 << (32 - idx)) - 1) << idx
    mask = (1 << idx) - 1
    if is_signed:
        return ((dat & mask) | signed) & M32
    return dat & mask


def _rotr(x: int, n: int) -> int:
    x &= M32
    return ((x >> n) | (x << (32 - n))) & M32


@dataclass
class Segment:
    """Matches the reference Segment JSON schema (state.rs:34-48)."""
    mem_image: Dict[int, int]
    pc: int
    segment_id: int
    pre_image_id: bytes
    pre_hash_root: bytes
    image_id: bytes
    page_hash_root: bytes
    end_pc: int
    step: int
    input_stream: List[bytes]
    input_stream_ptr: int
    public_values_stream: bytes
    public_values_stream_ptr: int

    def to_json(self) -> str:
        return json.dumps({
            "mem_image": {str(k): v for k, v in sorted(self.mem_image.items())},
            "pc": self.pc,
            "segment_id": self.segment_id,
            "pre_image_id": list(self.pre_image_id),
            "pre_hash_root": list(self.pre_hash_root),
            "image_id": list(self.image_id),
            "page_hash_root": list(self.page_hash_root),
            "end_pc": self.end_pc,
            "step": self.step,
            "input_stream": [list(v) for v in self.input_stream],
            "input_stream_ptr": self.input_stream_ptr,
            "public_values_stream": list(self.public_values_stream),
            "public_values_stream_ptr": self.public_values_stream_ptr,
        })

    @staticmethod
    def from_json(text: str) -> "Segment":
        d = json.loads(text)
        return Segment(
            mem_image={int(k): v for k, v in d["mem_image"].items()},
            pc=d["pc"], segment_id=d["segment_id"],
            pre_image_id=bytes(d["pre_image_id"]),
            pre_hash_root=bytes(d["pre_hash_root"]),
            image_id=bytes(d["image_id"]),
            page_hash_root=bytes(d["page_hash_root"]),
            end_pc=d["end_pc"], step=d["step"],
            input_stream=[bytes(v) for v in d["input_stream"]],
            input_stream_ptr=d["input_stream_ptr"],
            public_values_stream=bytes(d["public_values_stream"]),
            public_values_stream_ptr=d["public_values_stream_ptr"])


class State:
    def __init__(self, device=None, native: bool = False):
        if native:
            from .native import CoreMemory
            self.memory = CoreMemory(device)
        else:
            self.memory = Memory(device)
        self.registers = [0] * 32
        self.pc = 0
        self.next_pc = 4
        self.hi = 0
        self.lo = 0
        self.heap = 0
        self.brk = 0
        self.local_user = 0
        self.step = 0
        self.total_step = 0
        self.cycle = 0
        self.total_cycle = 0
        self.input_stream: List[bytes] = []
        self.input_stream_ptr = 0
        self.public_values_stream = bytearray()
        self.public_values_stream_ptr = 0
        self.exited = False
        self.exit_code = 0

    # -- loading -------------------------------------------------------------

    @staticmethod
    def load_elf_bytes(data: bytes, device=None,
                       native: bool = False) -> "State":
        f = parse_elf(data)
        s = State(device, native)
        s.pc = f.entry & M32
        s.next_pc = (f.entry + 4) & M32
        s.heap = 0x20000000
        hiaddr = 0
        for seg in f.segments:
            if seg.p_type == PT_MIPS_ABIFLAGS:
                continue
            payload = seg.data
            if seg.p_filesz != seg.p_memsz:
                if seg.p_type in (PT_LOAD, PT_TLS):
                    if seg.p_filesz < seg.p_memsz:
                        payload = payload + bytes(seg.p_memsz - seg.p_filesz)
                    else:
                        raise ValueError("invalid PT_LOAD: filesz > memsz")
                else:
                    raise ValueError("non-PT_LOAD segment with filesz != memsz")
            if seg.p_vaddr + seg.p_memsz >= 1 << 32:
                raise ValueError("program out of 32-bit mem range")
            hiaddr = max(hiaddr, (seg.p_vaddr + seg.p_memsz) & M32)
            if payload:
                s.memory.set_memory_range(seg.p_vaddr, payload)
        s.brk = (hiaddr - (hiaddr & PAGE_ADDR_MASK) + PAGE_SIZE) & M32
        s._elf = f
        return s

    def patch_elf(self):
        f = self._elf
        jr_ra = bytes([0x03, 0xE0, 0x00, 0x08, 0, 0, 0, 0])
        for name, value in f.symbols.items():
            if name in _PATCH_SYMBOLS or \
                    ("sys_common" in name and "thread_info" in name):
                self.memory.set_memory_range(value & M32, jr_ra)
            elif name == "runtime.MemProfileRate":
                self.memory.set_memory_range(value & M32, bytes(4))

    def patch_stack(self, args: List[str]):
        assert len(args) <= 2
        sp = INIT_SP
        self.memory.set_memory_range(sp - 4 * PAGE_SIZE, bytes(5 * PAGE_SIZE))
        self.registers[29] = sp

        def store(addr, v):
            self.memory.set_memory_range(addr, (v & M32).to_bytes(4, "big"))

        index = len(args)
        store(sp, index)
        cur_sp = sp + 4 * (index + 1)
        store(cur_sp, 0)          # argv terminator
        cur_sp += 4
        store(cur_sp, 0)          # envp terminator
        cur_sp += 4
        auxv = [(0x06, 0x1000), (0x0B, 0x3E8), (0x0C, 0x3E8), (0x0D, 0x3E8),
                (0x0E, 0x3E8), (0x10, 0x00), (0x11, 0x64), (0x17, 0x00)]
        for k, v in auxv:
            store(cur_sp, k)
            store(cur_sp + 4, v)
            cur_sp += 8
        store(cur_sp, 0x19)           # AT_RANDOM
        store(cur_sp + 4, cur_sp + 12)
        cur_sp += 8
        store(cur_sp, 0)
        cur_sp += 4
        for v in (0x5F28DF1D, 0x2CD1002A, 0x5FF9F682, 0xD4D8D538):
            store(cur_sp, v)
            cur_sp += 4
        store(cur_sp, 0)
        cur_sp += 4
        for i, arg in enumerate(args):
            store(sp + 4 * (i + 1), cur_sp)
            data = arg.encode()
            self.memory.set_memory_range(cur_sp, data)
            cur_sp += len(data) + 1

    @staticmethod
    def load_seg(seg: Segment, device=None) -> Tuple["State", int]:
        s = State(device)
        s.pc = seg.pc
        s.input_stream = list(seg.input_stream)
        s.input_stream_ptr = seg.input_stream_ptr
        s.public_values_stream = bytearray(seg.public_values_stream)
        s.public_values_stream_ptr = seg.public_values_stream_ptr
        img = seg.mem_image

        def reg(i):
            # image words are stored LE; register values were written BE
            return int.from_bytes(
                (img[REGISTERS_START + (i << 2)]).to_bytes(4, "little"), "big")

        for i in range(32):
            s.registers[i] = reg(i)
        s.lo = reg(32)
        s.hi = reg(33)
        s.heap = reg(34)
        s.next_pc = reg(36)
        s.brk = reg(37)
        s.local_user = reg(38)
        for addr, val in img.items():
            s.memory.init_memory(addr, val)
        return s, seg.step

    # -- io ------------------------------------------------------------------

    def add_input_stream(self, value) -> None:
        """bincode-compatible serialization of common python values."""
        self.input_stream.append(bincode_serialize(value))

    def add_input_stream_bytes(self, raw: bytes) -> None:
        self.input_stream.append(bytes(raw))

    def get_registers_bytes(self) -> bytes:
        vals = (self.registers + [self.lo, self.hi, self.heap, self.pc,
                                  self.next_pc, self.brk, self.local_user])
        return b"".join((v & M32).to_bytes(4, "big") for v in vals)


class InstrumentedState:
    def __init__(self, state: State, block_path: str = ""):
        self.state = state
        self.block_path = block_path
        self.pre_segment_id = 0
        self.pre_pc = 0
        self.pre_image_id = bytes(32)
        self.pre_hash_root = bytes(32)
        self.pre_input: List[bytes] = []
        self.pre_input_ptr = 0
        self.pre_public_values = b""
        self.pre_public_values_ptr = 0
        self.stdout_buf = bytearray()
        self.stderr_buf = bytearray()

    # -- syscalls ------------------------------------------------------------

    def _handle_syscall(self):
        s = self.state
        num = s.registers[2]
        v0, v1 = 0, 0
        a0, a1, a2 = s.registers[4], s.registers[5], s.registers[6]

        if num == 0x300105:   # SHA_EXTEND
            w = a0
            assert a1 == 0, "arg2 must be 0"
            for i in range(16, 64):
                w15 = s.memory.get_memory(w + (i - 15) * 4)
                s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
                w2 = s.memory.get_memory(w + (i - 2) * 4)
                s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
                w16 = s.memory.get_memory(w + (i - 16) * 4)
                w7 = s.memory.get_memory(w + (i - 7) * 4)
                wi = (s1 + w16 + s0 + w7) & M32
                s.memory.set_memory(w + i * 4, wi)
        elif num == 0x010106:  # SHA_COMPRESS
            w_ptr, h_ptr = a0, a1
            hx = [s.memory.get_memory(h_ptr + i * 4) for i in range(8)]
            a, b, c, d, e, f, g, h = hx
            for i in range(64):
                s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
                ch = (e & f) ^ ((~e & M32) & g)
                wi = s.memory.get_memory(w_ptr + i * 4)
                t1 = (h + s1 + ch + SHA_COMPRESS_K[i] + wi) & M32
                s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
                maj = (a & b) ^ (a & c) ^ (b & c)
                t2 = (s0 + maj) & M32
                h, g, f, e, d, c, b, a = \
                    g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
            for i, v in enumerate([a, b, c, d, e, f, g, h]):
                s.memory.set_memory(h_ptr + i * 4, (hx[i] + v) & M32)
        elif num == 0x010109:  # KECCAK
            assert a0 & 3 == 0 and a2 & 3 == 0
            data = bytes(s.memory.byte(a0 + i) for i in range(a1))
            digest = keccak256(data)
            for i in range(8):
                word = int.from_bytes(digest[i * 4:i * 4 + 4], "big")
                s.memory.set_memory(a2 + (i << 2), word)
        elif num == 0xF0:     # hint len
            if s.input_stream_ptr >= len(s.input_stream):
                raise RuntimeError("not enough vecs in hint input stream")
            v0 = len(s.input_stream[s.input_stream_ptr]) & M32
        elif num == 0xF1:     # hint read
            vec = s.input_stream[s.input_stream_ptr]
            s.input_stream_ptr += 1
            assert len(vec) == a1, "hint input stream read length mismatch"
            assert a0 % 4 == 0, "hint read address not aligned"
            if a1 >= 1:
                s.cycle += (a1 + 31) // 32
            for i in range(0, a1, 4):
                chunk = vec[i:i + 4] + bytes(4 - len(vec[i:i + 4]))
                s.memory.set_memory(a0 + i, int.from_bytes(chunk, "big"))
            v0 = a2
        elif num == 4020:     # getpid -> preimage oracle load
            self._load_preimage()
        elif num in (4210, 4090):  # mmap
            size = a1
            if size & PAGE_ADDR_MASK:
                size += PAGE_SIZE - (size & PAGE_ADDR_MASK)
            if a0 == 0:
                v0 = s.heap
                s.heap = (s.heap + size) & M32
            else:
                v0 = a0
        elif num == 4045:     # brk
            v0 = a0 if a0 > s.brk else s.brk
        elif num == 4120:     # clone
            v0 = 1
        elif num == 4246:     # exit_group
            s.exited = True
            s.exit_code = a0 & 0xFF
        elif num == 4003:     # read
            if a0 != FD_STDIN:
                v0, v1 = 0xFFFFFFFF, MIPS_EBADF
        elif num == 4004:     # write
            data = bytes(s.memory.byte(a1 + i) for i in range(a2))
            if a0 == FD_STDOUT:
                self.stdout_buf.extend(data)
                v0 = a2
            elif a0 == FD_STDERR:
                self.stderr_buf.extend(data)
                v0 = a2
            elif a0 == FD_PUBLIC_VALUES:
                s.public_values_stream.extend(data)
                v0 = a2
            elif a0 == FD_HINT:
                s.input_stream.append(data)
                v0 = a2
            else:
                v0, v1 = 0xFFFFFFFF, MIPS_EBADF
        elif num == 4055:     # fcntl
            if a1 == 3:
                if a0 == FD_STDIN:
                    v0 = 0
                elif a0 in (FD_STDOUT, FD_STDERR):
                    v0 = 1
                else:
                    v0, v1 = 0xFFFFFFFF, MIPS_EBADF
            elif a1 == 1:
                if a0 in (FD_STDIN, FD_STDOUT, FD_STDERR):
                    v0 = a0
                else:
                    v0, v1 = 0xFFFFFFFF, MIPS_EBADF
            else:
                v0, v1 = 0xFFFFFFFF, MIPS_EBADF
        elif num == 4283:     # set_thread_area
            s.local_user = a0
        elif num == 0xF2:     # sys_verify: no-op in emulator
            pass

        s.registers[2] = v0
        s.registers[7] = v1
        s.pc = s.next_pc
        s.next_pc = (s.next_pc + 4) & M32

    def _load_preimage(self):
        s = self.state
        hash_bytes = b"".join(
            s.memory.get_memory(0x30001000 + i * 4).to_bytes(4, "big")
            for i in range(8))
        path = self.block_path + "0x" + hash_bytes.hex()
        with open(path, "rb") as f:
            data = f.read()
        s.memory.set_memory(0x31000000, len(data) & M32)
        s.memory.set_memory_range(0x31000004, data)
        s.cycle += (len(data) + 35) // 32
        rem = len(data) & 3
        end = len(data) % 32
        if rem:
            final_addr = 0x31000004 + len(data) - rem
            word = s.memory.get_memory(final_addr)
            b = bytearray(word.to_bytes(4, "big"))
            for i in range(rem, 4):
                b[i] = 0
            b[rem] = 1
            if end + 4 > 32:
                b[3] |= 0b10000000
            s.memory.set_memory(final_addr, int.from_bytes(bytes(b), "big"))

    def load_input(self, blockpath: str):
        path = os.path.join(blockpath, "input")
        with open(path, "rb") as f:
            data = f.read()
        self.state.memory.set_memory_range(0x30000000, data)

    # -- interpreter ---------------------------------------------------------

    def _handle_branch(self, opcode, insn, rt_reg, rs):
        s = self.state
        if opcode in (4, 5):
            rt = s.registers[rt_reg]
            should = (rs == rt and opcode == 4) or (rs != rt and opcode == 5)
        elif opcode == 6:
            should = (rs - (1 << 32) if rs >> 31 else rs) <= 0
        elif opcode == 7:
            should = (rs - (1 << 32) if rs >> 31 else rs) > 0
        elif opcode == 1:
            rtv = (insn >> 16) & 0x1F
            srs = rs - (1 << 32) if rs >> 31 else rs
            if rtv == 0:
                should = srs < 0
            elif rtv == 1:
                should = srs >= 0
            elif rtv == 0b10001:  # bal
                s.registers[31] = (s.pc + 8) & M32
                should = True
            else:
                should = False
        else:
            raise ValueError(f"invalid branch opcode {opcode}")
        prev_pc = s.pc
        s.pc = s.next_pc
        if should:
            s.next_pc = (prev_pc + 4 +
                         (sign_extension(insn & 0xFFFF, 16) << 2)) & M32
        else:
            s.next_pc = (s.next_pc + 4) & M32

    def _handle_jump(self, link_reg, dest):
        s = self.state
        prev_pc = s.pc
        s.pc = s.next_pc
        s.next_pc = dest & M32
        if link_reg != 0:
            s.registers[link_reg] = (prev_pc + 8) & M32

    def _handle_hilo(self, fun, rs, rt, store_reg):
        s = self.state
        val = 0
        if fun == 0x01:   # maddu
            acc = (rs * rt + ((s.hi << 32) | s.lo)) & 0xFFFFFFFFFFFFFFFF
            s.hi, s.lo = (acc >> 32) & M32, acc & M32
        elif fun == 0x10:
            val = s.hi
        elif fun == 0x11:
            s.hi = rs
        elif fun == 0x12:
            val = s.lo
        elif fun == 0x13:
            s.lo = rs
        elif fun == 0x18:  # mult
            srs = rs - (1 << 32) if rs >> 31 else rs
            srt = rt - (1 << 32) if rt >> 31 else rt
            acc = (srs * srt) & 0xFFFFFFFFFFFFFFFF
            s.hi, s.lo = (acc >> 32) & M32, acc & M32
        elif fun == 0x19:  # multu
            acc = rs * rt
            s.hi, s.lo = (acc >> 32) & M32, acc & M32
        elif fun == 0x1A:  # div (truncated toward zero, like Rust i32 ops)
            srs = rs - (1 << 32) if rs >> 31 else rs
            srt = rt - (1 << 32) if rt >> 31 else rt
            if srt:
                q = abs(srs) // abs(srt)
                if (srs < 0) != (srt < 0):
                    q = -q
                r = srs - q * srt
                s.hi, s.lo = r & M32, q & M32
            else:
                s.hi, s.lo = srs & M32, 0
        elif fun == 0x1B:  # divu
            if rt:
                s.hi, s.lo = rs % rt, rs // rt
            else:
                s.hi, s.lo = rs, 0
        else:
            raise ValueError(f"invalid hilo fun {fun}")
        if store_reg != 0:
            s.registers[store_reg] = val
        s.pc = s.next_pc
        s.next_pc = (s.next_pc + 4) & M32

    def _handle_rd(self, store_reg, val, conditional):
        s = self.state
        if store_reg >= 32:
            raise ValueError("invalid register")
        if store_reg != 0 and conditional:
            s.registers[store_reg] = val & M32
        s.pc = s.next_pc
        s.next_pc = (s.next_pc + 4) & M32

    def mips_step(self):
        s = self.state
        if s.exited:
            return
        s.step += 1
        s.cycle += 1
        insn = s.memory.get_memory(s.pc)
        opcode = insn >> 26

        if opcode in (2, 3):  # j / jal
            link_reg = 31 if opcode == 3 else 0
            self._handle_jump(link_reg,
                              sign_extension(insn & 0x03FFFFFF, 26) << 2)
            return

        rt = 0
        rt_reg = (insn >> 16) & 0x1F
        rs = s.registers[(insn >> 21) & 0x1F]
        rd_reg = rt_reg
        fun = insn & 0x3F
        if opcode == 0 or opcode == 0x1C or \
                (opcode == 0x1F and (fun == 0x20 or fun == 4)):
            rt = s.registers[rt_reg]
            rd_reg = (insn >> 11) & 0x1F
        elif opcode < 0x20:
            if opcode in (0xC, 0xD, 0xE):
                rt = insn & 0xFFFF
            else:
                rt = sign_extension(insn & 0xFFFF, 16)
        elif opcode >= 0x28 or opcode == 0x22 or opcode == 0x26:
            rt = s.registers[rt_reg]
            rd_reg = rt_reg

        if 4 <= opcode < 8 or opcode == 1:
            self._handle_branch(opcode, insn, rt_reg, rs)
            return

        store_addr = None
        mem = 0
        if opcode >= 0x20:
            rs = (rs + sign_extension(insn & 0xFFFF, 16)) & M32
            addr = rs & 0xFFFFFFFC
            mem = s.memory.get_memory(addr)
            if opcode >= 0x28 and opcode != 0x30:
                store_addr = addr
                rd_reg = 0

        val = self._execute(insn, rs, rt, mem)

        fun = insn & 0x3F
        if opcode == 0 and 8 <= fun < 0x1C:
            if fun in (8, 9):   # jr / jalr
                self._handle_jump(rd_reg if fun == 9 else 0, rs)
                return
            if fun == 0xA:      # movz
                self._handle_rd(rd_reg, rs, rt == 0)
                return
            if fun == 0xB:      # movn
                self._handle_rd(rd_reg, rs, rt != 0)
                return
            if fun == 0xC:      # syscall
                self._handle_syscall()
                return
            if 0x10 <= fun < 0x1C:
                self._handle_hilo(fun, rs, rt, rd_reg)
                return
        if opcode == 0x1C and fun == 0x1:  # maddu
            self._handle_hilo(fun, rs, rt, rd_reg)
            return
        if opcode == 0 and fun == 0x34 and val == 1:  # teq
            pass  # trap: no-op
        if opcode == 0x38 and rt_reg != 0:  # sc
            s.registers[rt_reg] = 1
        if opcode == 0x33:  # pref
            self._handle_rd(0, val, False)
            return
        if store_addr is not None:
            s.memory.set_memory(store_addr, val)
        self._handle_rd(rd_reg, val, True)

    def _execute(self, insn, rs, rt, mem):
        opcode = insn >> 26
        fun = insn & 0x3F
        if opcode < 0x20:
            if 8 <= opcode < 0xF:
                fun = {8: 0x20, 9: 0x21, 0xA: 0x2A, 0xB: 0x2B,
                       0xC: 0x24, 0xD: 0x25, 0xE: 0x26}[opcode]
                opcode = 0
            if opcode == 0:
                shamt = (insn >> 6) & 0x1F
                if fun < 0x20:
                    if fun >= 0x08:
                        return rs
                    if fun == 0x00:
                        return (rt << shamt) & M32
                    if fun == 0x02:
                        sel = (insn >> 21) & 0x1F
                        if sel == 1:
                            return _rotr(rt, shamt)
                        if sel == 0:
                            return rt >> shamt
                    elif fun == 0x03:
                        return sign_extension(rt >> shamt, 32 - shamt)
                    elif fun == 0x04:
                        return (rt << (rs & 0x1F)) & M32
                    elif fun == 0x06:
                        return rt >> (rs & 0x1F)
                    elif fun == 0x07:
                        return sign_extension(rt >> (rs & 0x1F), 32 - (rs & 0x1F))
                if fun in (0x20, 0x21):
                    return (rs + rt) & M32
                if fun in (0x22, 0x23):
                    return (rs - rt) & M32
                if fun == 0x24:
                    return rs & rt
                if fun == 0x25:
                    return rs | rt
                if fun == 0x26:
                    return rs ^ rt
                if fun == 0x27:
                    return (~(rs | rt)) & M32
                if fun == 0x2A:
                    srs = rs - (1 << 32) if rs >> 31 else rs
                    srt = rt - (1 << 32) if rt >> 31 else rt
                    return 1 if srs < srt else 0
                if fun == 0x2B:
                    return 1 if rs < rt else 0
                if fun == 0x34:
                    return 1 if rs == rt else 0
                return 0
            if opcode == 0xF:
                return (rt << 16) & M32
            if opcode == 0x1C:  # SPECIAL2
                if fun == 1:
                    return rs
                if fun == 2:    # mul
                    return (rs * rt) & M32
                if fun in (0x20, 0x21):  # clz / clo
                    x = (~rs & M32) if fun == 0x20 else rs
                    i = 0
                    while x & 0x80000000:
                        x = (x << 1) & M32
                        i += 1
                    return i
                return 0
            if opcode == 0x1F:  # SPECIAL3
                if fun == 0:    # ext
                    msbd = (insn >> 11) & 0x1F
                    lsb = (insn >> 6) & 0x1F
                    mask = (1 << (msbd + 1)) - 1
                    return (rs >> lsb) & mask
                if fun == 4:    # ins
                    msb = (insn >> 11) & 0x1F
                    lsb = (insn >> 6) & 0x1F
                    size = msb - lsb + 1
                    mask = (1 << size) - 1
                    return ((rt & ~((mask << lsb) & M32)) |
                            ((rs & mask) << lsb)) & M32
                if fun == 0b111011:  # rdhwr
                    rd = (insn >> 11) & 0x1F
                    if rd == 0:
                        return 1
                    if rd == 29:
                        return self.state.local_user
                    return 0
                if fun == 0b100000:
                    shamt = (insn >> 6) & 0x1F
                    if shamt == 0x18:   # seh
                        return sign_extension(rt, 16)
                    if shamt == 0x10:   # seb
                        return sign_extension(rt, 8)
                    if shamt == 0x02:   # wsbh
                        return ((((rt >> 16) & 0xFF) << 24)
                                | (((rt >> 24) & 0xFF) << 16)
                                | ((rt & 0xFF) << 8)
                                | ((rt >> 8) & 0xFF)) & M32
                return 0
            return 0
        if opcode < 0x28:
            if opcode == 0x20:  # lb
                return sign_extension((mem >> (24 - (rs & 3) * 8)) & 0xFF, 8)
            if opcode == 0x21:  # lh
                return sign_extension((mem >> (16 - (rs & 2) * 8)) & 0xFFFF, 16)
            if opcode == 0x22:  # lwl
                val = (mem << ((rs & 3) * 8)) & M32
                mask = (0xFFFFFFFF << ((rs & 3) * 8)) & M32
                return (rt & (~mask & M32)) | val
            if opcode == 0x23:  # lw
                return mem
            if opcode == 0x24:  # lbu
                return (mem >> (24 - (rs & 3) * 8)) & 0xFF
            if opcode == 0x25:  # lhu
                return (mem >> (16 - (rs & 2) * 8)) & 0xFFFF
            if opcode == 0x26:  # lwr
                val = mem >> (24 - (rs & 3) * 8)
                mask = 0xFFFFFFFF >> (24 - (rs & 3) * 8)
                return (rt & (~mask & M32)) | val
            raise ValueError(f"invalid opcode {opcode:#x}")
        if opcode == 0x28:  # sb
            val = (rt & 0xFF) << (24 - (rs & 3) * 8)
            mask = M32 ^ (0xFF << (24 - (rs & 3) * 8))
            return (mem & mask) | val
        if opcode == 0x29:  # sh
            val = (rt & 0xFFFF) << (16 - (rs & 2) * 8)
            mask = M32 ^ (0xFFFF << (16 - (rs & 2) * 8))
            return (mem & mask) | val
        if opcode == 0x2A:  # swl
            val = rt >> ((rs & 3) * 8)
            mask = 0xFFFFFFFF >> ((rs & 3) * 8)
            return (mem & (~mask & M32)) | val
        if opcode == 0x2B:  # sw
            return rt
        if opcode == 0x2E:  # swr
            val = (rt << (24 - (rs & 3) * 8)) & M32
            mask = (0xFFFFFFFF << (24 - (rs & 3) * 8)) & M32
            return (mem & (~mask & M32)) | val
        if opcode == 0x30:  # ll
            return mem
        if opcode == 0x33:  # pref
            return mem
        if opcode == 0x38:  # sc
            return rt
        if opcode == 0x3D:  # sdc1
            return 0
        raise ValueError(f"invalid instruction opcode {opcode:#x} "
                         f"insn {insn:#x} pc {self.state.pc:#x}")

    # -- segmentation --------------------------------------------------------

    def step(self) -> int:
        self.mips_step()
        return (self.state.cycle
                + (self.state.memory.page_count() + 1) * PAGE_CYCLES
                + RESERVE_CYCLES)

    def run_fast(self, max_steps: int) -> int:
        """Run up to max_steps using the native core when the state has one.

        The core returns at every syscall, which is then executed by the
        Python interpreter (single source of truth for syscall semantics);
        a fault of the core is replayed in Python and raises.  Returns the
        number of steps executed.
        """
        mem = self.state.memory
        if not hasattr(mem, "run"):  # pure-Python memory: no native core
            done = 0
            while done < max_steps and not self.state.exited:
                self.mips_step()
                done += 1
            return done
        from .native import STOP_FAULT, STOP_SYSCALL
        total = 0
        while total < max_steps and not self.state.exited:
            reason, done = mem.run(self.state, max_steps - total)
            total += done
            if reason == STOP_SYSCALL and not self.state.exited:
                before = self.state.step
                self.mips_step()  # executes the syscall via Python
                total += self.state.step - before
            elif reason == STOP_FAULT:
                # replay the faulting instruction in Python for a good error
                self.mips_step()
                raise RuntimeError("native core fault not reproduced")
        return total

    def split_segment(self, emit: bool, output_dir: Optional[str] = None
                      ) -> Optional[Segment]:
        s = self.state
        s.total_cycle += s.cycle + (s.memory.page_count() + 1) * PAGE_CYCLES
        s.total_step += s.step
        s.memory.update_page_hash()
        registers = s.get_registers_bytes()
        # preload the public-input pages (reference quirk, state.rs:1490-1492)
        s.memory.get_memory(INIT_SP)
        s.memory.get_memory(INIT_SP + PAGE_SIZE)
        image_id, page_hash_root = s.memory.compute_image_id(s.pc, registers)
        image = s.memory.get_input_image()

        seg = None
        if emit:
            seg = Segment(
                mem_image=image, segment_id=self.pre_segment_id,
                pc=self.pre_pc, pre_hash_root=self.pre_hash_root,
                pre_image_id=self.pre_image_id, image_id=image_id,
                end_pc=s.pc, step=s.step, page_hash_root=page_hash_root,
                input_stream=list(self.pre_input),
                input_stream_ptr=self.pre_input_ptr,
                public_values_stream=bytes(self.pre_public_values),
                public_values_stream_ptr=self.pre_public_values_ptr)
            if output_dir is not None:
                with open(os.path.join(output_dir,
                                       str(self.pre_segment_id)), "w") as f:
                    f.write(seg.to_json())
            self.pre_segment_id += 1

        self.pre_input = list(s.input_stream)
        self.pre_input_ptr = s.input_stream_ptr
        self.pre_public_values = bytes(s.public_values_stream)
        self.pre_public_values_ptr = s.public_values_stream_ptr
        self.pre_pc = s.pc
        self.pre_image_id = image_id
        self.pre_hash_root = page_hash_root
        s.cycle = 0
        s.step = 0
        return seg
