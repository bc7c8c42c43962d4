# Frozen copy of zkm_tpu_torch/emulator/memory.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Paged sparse memory with Poseidon page-hash merkleization.

Copy of zkm_tpu/emulator/memory.py (zkMIPS emulator/src/memory.rs).
Semantics mirrored:
  * 4 KiB pages, big-endian u32 word accesses (MIPS BE).
  * Page hashes live *in the address space*: the 32-byte hash of page index
    i is stored at 0x80000000 + (i << 5); 3 hash levels; the root page is
    page index 0x81020 with the packed registers at offset 0x400.
  * rtrace records each page's content at first touch within the current
    segment (the segment's mem_image); wtrace tracks dirty pages per hash
    level for incremental re-hashing.
  * Untouched hash pages read as "const hash pages" (hash chain of the zero
    page), computed lazily.

Dirty pages are re-hashed in one batched byte sponge per level
(`hash.poseidon.hash_pages`: one K1 launch per block index on the card).
A `Memory` hashes on the device it was given (None: the card; hashing
raises without one unless the device is "cpu").
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..hash import poseidon as ps

PAGE_ADDR_SIZE = 12
PAGE_SIZE = 1 << PAGE_ADDR_SIZE
PAGE_ADDR_MASK = PAGE_SIZE - 1
MAX_MEMORY = 0x8000_0000
HASH_LEVEL = 3

HASH_ADDRESS_BASE = 0x8000_0000
ROOT_PAGE_INDEX = 0x81020
REGISTERS_OFFSET = 0x400
INIT_SP = 0x7FFF_D000
POSEIDON_RATE_BYTES = 32


def hash_page_bytes(data: bytes, device=None) -> bytes:
    """Poseidon page hash -> 32 bytes (LE u64 digits)."""
    assert len(data) == PAGE_SIZE
    words = np.frombuffer(data, dtype="<u4")
    digest = ps.hash_pages(words[None], device)[0]
    return b"".join(int(x).to_bytes(8, "little") for x in digest)


class _ConstHashPages:
    """Level-l page contents when the entire subtree below is zero
    (device-independent values; hashed on the first caller's device)."""

    def __init__(self):
        self._pages = None

    def get(self, level: int, device=None) -> bytes:
        if self._pages is None:
            pages = []
            cur_hash = hash_page_bytes(bytes(PAGE_SIZE), device)
            for _ in range(HASH_LEVEL):
                page = cur_hash * (PAGE_SIZE // 32)
                pages.append(page)
                cur_hash = hash_page_bytes(page, device)
            self._pages = pages
        return self._pages[level]


_CONST_HASH_PAGES = _ConstHashPages()


class Memory:
    def __init__(self, device=None):
        self.device = device
        self.pages: Dict[int, bytearray] = {}
        self.rtrace: Dict[int, bytes] = {}
        self.wtrace = [set(), set(), set()]  # page indices per hash level

    # -- internals -----------------------------------------------------------

    def page_count(self) -> int:
        return len(self.rtrace)

    def _page(self, page_index: int) -> Optional[bytearray]:
        return self.pages.get(page_index)

    def _alloc_page(self, page_index: int) -> bytearray:
        p = bytearray(PAGE_SIZE)
        self.pages[page_index] = p
        return p

    def _alloc_hash_page(self, page_index: int, level: int) -> bytearray:
        p = bytearray(_CONST_HASH_PAGES.get(level, self.device))
        self.pages[page_index] = p
        return p

    def _set_hash_trace(self, page_index: int, level: int):
        hash_addr = ((page_index << 5) + HASH_ADDRESS_BASE) & 0xFFFFFFFF
        hp_index = hash_addr >> PAGE_ADDR_SIZE
        page = self._page(hp_index)
        if page is None:
            page = self._alloc_hash_page(hp_index, level)
        if hp_index not in self.rtrace:
            self.rtrace[hp_index] = bytes(page)
        if level < 2:
            self._set_hash_trace(hp_index, level + 1)

    def _touch_read(self, page_index: int, page: Optional[bytearray]):
        if page_index not in self.rtrace:
            self.rtrace[page_index] = bytes(page) if page is not None \
                else bytes(PAGE_SIZE)
            self._set_hash_trace(page_index, 0)

    # -- public API ----------------------------------------------------------

    def get_memory(self, addr: int) -> int:
        if addr & 3:
            raise ValueError(f"unaligned memory access: {addr:x}")
        page_index = addr >> PAGE_ADDR_SIZE
        page = self._page(page_index)
        if page is None:
            self.rtrace.setdefault(page_index, bytes(PAGE_SIZE))
            self._set_hash_trace(page_index, 0)
            return 0
        self._touch_read(page_index, page)
        off = addr & PAGE_ADDR_MASK
        return int.from_bytes(page[off:off + 4], "big")

    def byte(self, addr: int) -> int:
        word = self.get_memory(addr & 0xFFFFFFFC)
        return (word >> (24 - (addr & 3) * 8)) & 0xFF

    def set_memory(self, addr: int, v: int):
        if addr & 3:
            raise ValueError(f"unaligned memory access: {addr:x}")
        page_index = addr >> PAGE_ADDR_SIZE
        page = self._page(page_index)
        if page is None:
            page = self._alloc_page(page_index)
        self._touch_read(page_index, page)
        self.wtrace[0].add(page_index)
        off = addr & PAGE_ADDR_MASK
        page[off:off + 4] = (v & 0xFFFFFFFF).to_bytes(4, "big")

    def set_memory_range(self, addr: int, data: bytes):
        """Raw byte blit (records read+write traces like the reference)."""
        pos = 0
        while pos < len(data):
            page_index = addr >> PAGE_ADDR_SIZE
            off = addr & PAGE_ADDR_MASK
            page = self._page(page_index)
            if page is None:
                page = self._alloc_page(page_index)
            self._touch_read(page_index, page)
            self.wtrace[0].add(page_index)
            n = min(PAGE_SIZE - off, len(data) - pos)
            page[off:off + n] = data[pos:pos + n]
            pos += n
            addr += n

    def init_memory(self, addr: int, v: int):
        """Segment-image restore: little-endian word write, no tracing."""
        page_index = addr >> PAGE_ADDR_SIZE
        page = self._page(page_index)
        if page is None:
            page = self._alloc_page(page_index)
        off = addr & PAGE_ADDR_MASK
        page[off:off + 4] = (v & 0xFFFFFFFF).to_bytes(4, "little")

    # -- hashing -------------------------------------------------------------

    def _write_hash(self, page_index: int, digest: bytes, level: int):
        hash_addr = ((page_index << 5) + HASH_ADDRESS_BASE) & 0xFFFFFFFF
        hp_index = hash_addr >> PAGE_ADDR_SIZE
        off = hash_addr & PAGE_ADDR_MASK
        page = self._page(hp_index)
        if page is None:
            page = self._alloc_hash_page(hp_index, level)
        page[off:off + 32] = digest
        if level < 2:
            self.wtrace[level + 1].add(hp_index)

    def update_page_hash(self):
        """Batched re-hash of all dirty pages, level by level."""
        for level in range(HASH_LEVEL):
            dirty = sorted(self.wtrace[level])
            self.wtrace[level] = set()
            if not dirty:
                continue
            datas = np.stack([
                np.frombuffer(bytes(self.pages[pi]), dtype="<u4")
                for pi in dirty])
            digests = ps.hash_pages(datas, self.device)  # (n, 4) u64
            for pi, dig in zip(dirty, digests):
                raw = b"".join(int(x).to_bytes(8, "little") for x in dig)
                self._write_hash(pi, raw, level)

    def compute_image_id(self, pc: int, registers_bytes: bytes):
        """Returns (image_id (32B), page_hash_root (32B))."""
        root = self._page(ROOT_PAGE_INDEX)
        if root is None:
            raise RuntimeError("compute image ID fail: no root page")
        root[REGISTERS_OFFSET:REGISTERS_OFFSET + len(registers_bytes)] = \
            registers_bytes
        hash_root = hash_page_bytes(bytes(root), self.device)
        # image_id = poseidon( per-u32-byteswapped hash_root || pc_le )
        swapped = b"".join(
            hash_root[i:i + 4][::-1] for i in range(0, 32, 4))
        final = swapped + (pc & 0xFFFFFFFF).to_bytes(4, "little")
        digest = ps.poseidon_bytes(final, self.device)
        image_id = b"".join(int(x).to_bytes(8, "little") for x in digest)
        return image_id, hash_root

    def get_input_image(self) -> Dict[int, int]:
        """Segment mem_image: LE words of every rtrace'd page; clears rtrace."""
        image = {}
        for page_index, data in self.rtrace.items():
            base = page_index << PAGE_ADDR_SIZE
            words = np.frombuffer(data, dtype="<u4")
            for i, w in enumerate(words):
                image[base + (i << 2)] = int(w)
        self.rtrace = {}
        return image

    def usage(self) -> int:
        return len(self.pages) * PAGE_SIZE
