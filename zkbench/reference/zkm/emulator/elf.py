# Frozen copy of zkm_tpu_torch/emulator/elf.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""Minimal 32-bit big-endian (MIPS) ELF parser: program headers + symtab.

Copy of zkm_tpu/emulator/elf.py.  Reference: the `elf` crate usage in
zkMIPS emulator/src/state.rs:209-343 (load + patch).  Only the pieces the
zkVM loader needs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List

PT_LOAD = 1
PT_TLS = 7
PT_MIPS_ABIFLAGS = 0x70000003


@dataclass
class Segment:
    p_type: int
    p_vaddr: int
    p_filesz: int
    p_memsz: int
    data: bytes


@dataclass
class ElfFile:
    entry: int
    segments: List[Segment]
    symbols: Dict[str, int]  # name -> st_value


def parse_elf(data: bytes) -> ElfFile:
    assert data[:4] == b"\x7fELF", "not an ELF file"
    ei_class, ei_data = data[4], data[5]
    assert ei_class == 1, "expected 32-bit ELF"
    end = ">" if ei_data == 2 else "<"

    (e_entry, e_phoff, e_shoff) = struct.unpack_from(end + "III", data, 0x18)
    (e_phentsize, e_phnum, e_shentsize, e_shnum, e_shstrndx) = \
        struct.unpack_from(end + "HHHHH", data, 0x2A)

    segments = []
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, _p_paddr, p_filesz, p_memsz,
         _p_flags, _p_align) = struct.unpack_from(end + "8I", data, off)
        segments.append(Segment(
            p_type=p_type, p_vaddr=p_vaddr, p_filesz=p_filesz,
            p_memsz=p_memsz, data=data[p_offset:p_offset + p_filesz]))

    # section headers -> find .symtab / .strtab
    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (sh_name, sh_type, _f, _a, sh_offset, sh_size, sh_link, _i2,
         _al, sh_entsize) = struct.unpack_from(end + "10I", data, off)
        sections.append((sh_name, sh_type, sh_offset, sh_size, sh_link,
                         sh_entsize))

    symbols: Dict[str, int] = {}
    SHT_SYMTAB = 2
    for (sh_name, sh_type, sh_offset, sh_size, sh_link, sh_entsize) in sections:
        if sh_type != SHT_SYMTAB or sh_entsize == 0:
            continue
        str_off, str_size = sections[sh_link][2], sections[sh_link][3]
        strtab = data[str_off:str_off + str_size]
        for off in range(sh_offset, sh_offset + sh_size, sh_entsize):
            st_name, st_value = struct.unpack_from(end + "II", data, off)
            if st_name == 0:
                continue
            nul = strtab.find(b"\x00", st_name)
            name = strtab[st_name:nul].decode("utf-8", "replace")
            symbols[name] = st_value
    return ElfFile(entry=e_entry, segments=segments, symbols=symbols)
