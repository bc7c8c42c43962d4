"""ctypes bindings for the native C++ MIPS interpreter core.

Copy of zkm_tpu/emulator/native.py.  The core (`csrc/mips_core.cpp`, host
code) executes the interpreter loop ~100x faster than the Python one;
Python keeps handling syscalls (the core returns at every `syscall`
instruction) and the Poseidon page hashing runs through the port's byte
sponge on the state's device (K1 on the card).

The core is built at first use with g++ into `zkm_tpu_torch/_build/`; the
library's file name carries a hash of the source and flags, so an edit
rebuilds it.  Unlike zkm_tpu there is no fallback: when the core cannot be
built or loaded, `load_core` raises `NativeCoreError`, and so does every
`State(native=True)`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np

from ..hash import poseidon as ps
from .memory import (_CONST_HASH_PAGES, HASH_ADDRESS_BASE, HASH_LEVEL,
                     PAGE_ADDR_SIZE, PAGE_SIZE, REGISTERS_OFFSET,
                     ROOT_PAGE_INDEX, hash_page_bytes)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "mips_core.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

STOP_STEPS, STOP_SYSCALL, STOP_FAULT = 0, 1, 2

_core_lib = None
_lock = threading.Lock()


class NativeCoreError(RuntimeError):
    pass


class CoreRegs(ctypes.Structure):
    _fields_ = [("regs", ctypes.c_uint32 * 32),
                ("pc", ctypes.c_uint32), ("next_pc", ctypes.c_uint32),
                ("hi", ctypes.c_uint32), ("lo", ctypes.c_uint32),
                ("heap", ctypes.c_uint32), ("brk_", ctypes.c_uint32),
                ("local_user", ctypes.c_uint32),
                ("step", ctypes.c_uint64), ("cycle", ctypes.c_uint64)]


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmips_core_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the core unless its library exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise NativeCoreError(
            f"native core: no C++ compiler `{CXX}` on PATH to build "
            f"{SOURCE}; run with native=False for the Python interpreter")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeCoreError(
            f"native core: {CXX} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_core() -> ctypes.CDLL:
    """The loaded native core, built first if needed."""
    global _core_lib
    with _lock:
        if _core_lib is not None:
            return _core_lib
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeCoreError(f"native core: cannot load {path}: {e}")
        _bind(lib)
        _core_lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    P, U32, U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    U32P = ctypes.POINTER(ctypes.c_uint32)
    sigs = {
        "core_new": (P, [ctypes.c_char_p]),
        "core_free": (None, [P]),
        "core_get_regs": (None, [P, ctypes.POINTER(CoreRegs)]),
        "core_set_regs": (None, [P, ctypes.POINTER(CoreRegs)]),
        "core_get_memory": (U32, [P, U32]),
        "core_set_memory": (None, [P, U32, U32]),
        "core_write_block": (None, [P, U32, ctypes.c_char_p, U32]),
        "core_init_memory": (None, [P, U32, U32]),
        "core_run": (ctypes.c_int, [P, U64, ctypes.POINTER(U64)]),
        "core_page_count": (U64, [P]),
        "core_rtrace_dump": (U64, [P, U32P, ctypes.c_char_p, U64]),
        "core_rtrace_clear": (None, [P]),
        "core_wtrace_count": (U64, [P, ctypes.c_int]),
        "core_wtrace_dump": (U64, [P, ctypes.c_int, U32P, U64]),
        "core_wtrace_clear": (None, [P, ctypes.c_int]),
        "core_wtrace_add": (None, [P, ctypes.c_int, U32]),
        "core_read_page": (None, [P, U32, ctypes.c_char_p]),
        "core_write_raw": (None, [P, U32, ctypes.c_char_p, U32]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


class CoreMemory:
    """Memory API backed by the native core (mirrors emulator.memory.Memory);
    pages are hashed on `device` (None: the card)."""

    def __init__(self, device=None):
        self.device = device
        self._lib = load_core()
        const_pages = b"".join(_CONST_HASH_PAGES.get(lv, device)
                               for lv in range(HASH_LEVEL))
        self._h = ctypes.c_void_p(self._lib.core_new(const_pages))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.core_free(self._h)
            self._h = None

    def get_memory(self, addr: int) -> int:
        if addr & 3:
            raise ValueError(f"unaligned memory access: {addr:x}")
        return int(self._lib.core_get_memory(self._h, addr))

    def byte(self, addr: int) -> int:
        word = self.get_memory(addr & 0xFFFFFFFC)
        return (word >> (24 - (addr & 3) * 8)) & 0xFF

    def set_memory(self, addr: int, v: int):
        if addr & 3:
            raise ValueError(f"unaligned memory access: {addr:x}")
        self._lib.core_set_memory(self._h, addr, v & 0xFFFFFFFF)

    def set_memory_range(self, addr: int, data: bytes):
        self._lib.core_write_block(self._h, addr, bytes(data), len(data))

    def init_memory(self, addr: int, v: int):
        self._lib.core_init_memory(self._h, addr, v & 0xFFFFFFFF)

    def page_count(self) -> int:
        return int(self._lib.core_page_count(self._h))

    def _read_page(self, page_index: int) -> bytes:
        buf = ctypes.create_string_buffer(PAGE_SIZE)
        self._lib.core_read_page(self._h, page_index, buf)
        return buf.raw

    def update_page_hash(self):
        for level in range(HASH_LEVEL):
            count = int(self._lib.core_wtrace_count(self._h, level))
            if not count:
                continue
            idx = (ctypes.c_uint32 * count)()
            got = int(self._lib.core_wtrace_dump(self._h, level, idx, count))
            self._lib.core_wtrace_clear(self._h, level)
            dirty = sorted(idx[i] for i in range(got))
            datas = np.stack([
                np.frombuffer(self._read_page(pi), dtype="<u4")
                for pi in dirty])
            digests = ps.hash_pages(datas, self.device)
            for pi, dig in zip(dirty, digests):
                raw = b"".join(int(x).to_bytes(8, "little") for x in dig)
                hash_addr = ((pi << 5) + HASH_ADDRESS_BASE) & 0xFFFFFFFF
                self._lib.core_write_raw(self._h, hash_addr, raw, 32)
                if level < 2:
                    self._lib.core_wtrace_add(
                        self._h, level + 1, hash_addr >> PAGE_ADDR_SIZE)

    def compute_image_id(self, pc: int, registers_bytes: bytes):
        root_addr = (ROOT_PAGE_INDEX << PAGE_ADDR_SIZE) + REGISTERS_OFFSET
        self._lib.core_write_raw(self._h, root_addr, registers_bytes,
                                 len(registers_bytes))
        hash_root = hash_page_bytes(self._read_page(ROOT_PAGE_INDEX),
                                    self.device)
        swapped = b"".join(hash_root[i:i + 4][::-1] for i in range(0, 32, 4))
        final = swapped + (pc & 0xFFFFFFFF).to_bytes(4, "little")
        digest = ps.poseidon_bytes(final, self.device)
        image_id = b"".join(int(x).to_bytes(8, "little") for x in digest)
        return image_id, hash_root

    def get_input_image(self) -> Dict[int, int]:
        count = max(1, int(self._lib.core_page_count(self._h)))
        idx = (ctypes.c_uint32 * count)()
        snaps = ctypes.create_string_buffer(count * PAGE_SIZE)
        got = int(self._lib.core_rtrace_dump(self._h, idx, snaps, count))
        self._lib.core_rtrace_clear(self._h)
        image = {}
        for i in range(got):
            base = idx[i] << PAGE_ADDR_SIZE
            words = np.frombuffer(
                snaps.raw[i * PAGE_SIZE:(i + 1) * PAGE_SIZE], dtype="<u4")
            for j, w in enumerate(words):
                image[base + (j << 2)] = int(w)
        return image

    # -- register sync with the core ----------------------------------------

    def push_regs(self, state):
        r = CoreRegs()
        for i in range(32):
            r.regs[i] = state.registers[i]
        r.pc, r.next_pc = state.pc, state.next_pc
        r.hi, r.lo = state.hi, state.lo
        r.heap, r.brk_ = state.heap, state.brk
        r.local_user = state.local_user
        r.step, r.cycle = state.step, state.cycle
        self._lib.core_set_regs(self._h, ctypes.byref(r))

    def pull_regs(self, state):
        r = CoreRegs()
        self._lib.core_get_regs(self._h, ctypes.byref(r))
        state.registers = [int(r.regs[i]) for i in range(32)]
        state.pc, state.next_pc = int(r.pc), int(r.next_pc)
        state.hi, state.lo = int(r.hi), int(r.lo)
        state.heap, state.brk = int(r.heap), int(r.brk_)
        state.local_user = int(r.local_user)
        state.step, state.cycle = int(r.step), int(r.cycle)

    def run(self, state, max_steps: int) -> Tuple[int, int]:
        """Run up to max_steps in the core; returns (reason, steps_done)."""
        self.push_regs(state)
        done = ctypes.c_uint64()
        reason = int(self._lib.core_run(self._h, max_steps,
                                        ctypes.byref(done)))
        self.pull_regs(state)
        return reason, int(done.value)
