# Frozen copy of zkm_tpu_torch/stark/all_stark.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""AllStark: the zkVM's STARK tables and their cross-table lookups.

Counterpart of zkm_tpu/stark/all_stark.py (zkMIPS prover/src/all_stark.rs:
the Table enum, all_stark.rs:96-110, and the 15 CTLs, all_stark.rs:136-154).
`make_all_stark` builds any subset of the 12 tables with the reference's
CTL topology restricted to the subset, in the reference's CTL order, and
raises NotImplementedError naming a table that IMPLEMENTED lacks.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Optional, Sequence

from ..tables import arithmetic as arith_mod
from ..tables import keccak as keccak_mod
from ..tables import keccak_sponge as ksponge_mod
from ..tables import logic as logic_mod
from ..tables import memory as memory_mod
from ..tables import poseidon as poseidon_mod
from ..tables import poseidon_sponge as psponge_mod
from ..tables import sha_compress as shac_mod
from ..tables import sha_compress_sponge as shacs_mod
from ..tables import sha_extend as shae_mod
from ..tables import sha_extend_sponge as shaes_mod
from ..tables.cpu import CpuStark, CpuStarkImageBound
from ..tables.cpu import ctl as cpu_ctl
from .cross_table_lookup import CrossTableLookup, TableWithColumns


class Table(IntEnum):
    """Table indices (reference all_stark.rs:96-110)."""
    Arithmetic = 0
    Cpu = 1
    Poseidon = 2
    PoseidonSponge = 3
    Keccak = 4
    KeccakSponge = 5
    ShaExtend = 6
    ShaExtendSponge = 7
    ShaCompress = 8
    ShaCompressSponge = 9
    Logic = 10
    Memory = 11


# Tables the port implements.
IMPLEMENTED: Dict[Table, object] = {
    Table.Arithmetic: arith_mod.ArithmeticStark,
    Table.Cpu: CpuStark,
    Table.Poseidon: poseidon_mod.PoseidonStark,
    Table.PoseidonSponge: psponge_mod.PoseidonSpongeStark,
    Table.Keccak: keccak_mod.KeccakStark,
    Table.KeccakSponge: ksponge_mod.KeccakSpongeStark,
    Table.ShaExtend: shae_mod.ShaExtendStark,
    Table.ShaExtendSponge: shaes_mod.ShaExtendSpongeStark,
    Table.ShaCompress: shac_mod.ShaCompressStark,
    Table.ShaCompressSponge: shacs_mod.ShaCompressSpongeStark,
    Table.Logic: logic_mod.LogicStark,
    Table.Memory: memory_mod.MemoryStark,
}

# Subset with the Poseidon sponge chain: the bootstrap/exit kernels hash
# every memory page and the image ids inside the proof.
SPONGE_SUBSET = (Table.Arithmetic, Table.Cpu, Table.Poseidon,
                 Table.PoseidonSponge, Table.Logic, Table.Memory)

# Sponge subset + the keccak syscall tables.
KECCAK_SUBSET = (Table.Arithmetic, Table.Cpu, Table.Poseidon,
                 Table.PoseidonSponge, Table.Keccak, Table.KeccakSponge,
                 Table.Logic, Table.Memory)

# All 12 tables (the reference's full system, all_stark.rs:96-110).
FULL_SUBSET = tuple(Table)


@dataclass
class AllStark:
    """A STARK system over a (sub)set of the tables.

    `tables` maps system-local indices 0..k-1 to Table ids; `starks` and
    `ctls` use the local indices (so a 4-table subset proves standalone)."""
    tables: List[Table]
    starks: List[object]
    ctls: List[CrossTableLookup]


def _ctl_arithmetic(loc) -> CrossTableLookup:
    """CPU (R-type + imm looking) <-> Arithmetic (all_stark.rs
    ctl_arithmetic)."""
    return CrossTableLookup(
        (TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_arithmetic_base_cols()),
                          cpu_ctl.ctl_arithmetic_base_filter()),
         TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_arithmetic_imm_cols()),
                          cpu_ctl.ctl_arithmetic_imm_filter())),
        TableWithColumns(loc[Table.Arithmetic],
                         tuple(arith_mod.ctl_data()),
                         arith_mod.ctl_filter()))


def _ctl_logic(loc) -> CrossTableLookup:
    """CPU (+imm +jumpi) and KeccakSponge's absorb XORs <-> Logic."""
    looking = [
        TableWithColumns(loc[Table.Cpu], tuple(cpu_ctl.ctl_logic_cols()),
                         cpu_ctl.ctl_logic_filter()),
        TableWithColumns(loc[Table.Cpu], tuple(cpu_ctl.ctl_logic_imm_cols()),
                         cpu_ctl.ctl_logic_imm_filter()),
        TableWithColumns(loc[Table.Cpu],
                         tuple(cpu_ctl.ctl_logic_jumpi_cols()),
                         cpu_ctl.ctl_logic_jumpi_filter()),
    ]
    if Table.KeccakSponge in loc:
        looking += [
            TableWithColumns(loc[Table.KeccakSponge],
                             tuple(ksponge_mod.ctl_looking_logic(w)),
                             ksponge_mod.ctl_looking_logic_filter())
            for w in range(ksponge_mod.RATE_U32S)
        ]
    return CrossTableLookup(
        tuple(looking),
        TableWithColumns(loc[Table.Logic], tuple(logic_mod.ctl_data()),
                         logic_mod.ctl_filter()))


def _ctl_memory(loc) -> CrossTableLookup:
    """CPU GP channels (and sponge word reads) <-> Memory."""
    looking = [
        TableWithColumns(loc[Table.Cpu],
                         tuple(cpu_ctl.ctl_gp_memory_cols(ch)),
                         cpu_ctl.ctl_gp_memory_filter(ch))
        for ch in range(cpu_ctl.cc.NUM_GP_CHANNELS)
    ]
    if Table.PoseidonSponge in loc:
        looking += [
            TableWithColumns(loc[Table.PoseidonSponge],
                             tuple(psponge_mod.ctl_looking_memory(w)),
                             psponge_mod.ctl_looking_memory_filter(w))
            for w in range(psponge_mod.SPONGE_RATE)
        ]
    if Table.KeccakSponge in loc:
        looking += [
            TableWithColumns(loc[Table.KeccakSponge],
                             tuple(ksponge_mod.ctl_looking_memory(w)),
                             ksponge_mod.ctl_looking_memory_filter(w))
            for w in range(ksponge_mod.RATE_U32S)
        ]
    if Table.ShaExtendSponge in loc:
        looking += [
            TableWithColumns(loc[Table.ShaExtendSponge],
                             tuple(shaes_mod.ctl_looking_memory(i)),
                             shaes_mod.ctl_looking_memory_filter(i))
            for i in range(shaes_mod.NUM_MEMORY_CTLS)
        ]
    if Table.ShaCompressSponge in loc:
        looking += [
            TableWithColumns(loc[Table.ShaCompressSponge],
                             tuple(shacs_mod.ctl_looking_memory(i)),
                             shacs_mod.ctl_looking_memory_filter(i))
            for i in range(shacs_mod.NUM_MEMORY_CTLS)
        ]
    if Table.ShaCompress in loc:
        looking.append(
            TableWithColumns(loc[Table.ShaCompress],
                             tuple(shac_mod.ctl_looking_memory()),
                             shac_mod.ctl_looking_memory_filter()))
    return CrossTableLookup(
        tuple(looking),
        TableWithColumns(loc[Table.Memory], tuple(memory_mod.ctl_data()),
                         memory_mod.ctl_filter()))


def _ctl_poseidon_sponge(loc) -> CrossTableLookup:
    """CPU sponge rows <-> PoseidonSponge final rows (all_stark.rs
    ctl_poseidon_sponge)."""
    return CrossTableLookup(
        (TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_poseidon_sponge_cols()),
                          cpu_ctl.ctl_poseidon_sponge_filter()),),
        TableWithColumns(loc[Table.PoseidonSponge],
                         tuple(psponge_mod.ctl_looked_data()),
                         psponge_mod.ctl_looked_filter()))


def _ctl_poseidon_inputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.PoseidonSponge],
                          tuple(psponge_mod.ctl_looking_poseidon_inputs()),
                          psponge_mod.ctl_looking_poseidon_filter()),),
        TableWithColumns(loc[Table.Poseidon],
                         tuple(poseidon_mod.ctl_data_inputs()),
                         poseidon_mod.ctl_filter()))


def _ctl_poseidon_outputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.PoseidonSponge],
                          tuple(psponge_mod.ctl_looking_poseidon_outputs()),
                          psponge_mod.ctl_looking_poseidon_filter()),),
        TableWithColumns(loc[Table.Poseidon],
                         tuple(poseidon_mod.ctl_data_outputs()),
                         poseidon_mod.ctl_filter()))


def _ctl_keccak_sponge(loc) -> CrossTableLookup:
    """CPU keccak rows <-> KeccakSponge final rows (all_stark.rs
    ctl_keccak_sponge)."""
    return CrossTableLookup(
        (TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_keccak_sponge_cols()),
                          cpu_ctl.ctl_keccak_sponge_filter()),),
        TableWithColumns(loc[Table.KeccakSponge],
                         tuple(ksponge_mod.ctl_looked_data()),
                         ksponge_mod.ctl_looked_filter()))


def _ctl_keccak_inputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.KeccakSponge],
                          tuple(ksponge_mod.ctl_looking_keccak_inputs()),
                          ksponge_mod.ctl_looking_keccak_filter()),),
        TableWithColumns(loc[Table.Keccak],
                         tuple(keccak_mod.ctl_data_inputs()),
                         keccak_mod.ctl_filter_inputs()))


def _ctl_keccak_outputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.KeccakSponge],
                          tuple(ksponge_mod.ctl_looking_keccak_outputs()),
                          ksponge_mod.ctl_looking_keccak_filter()),),
        TableWithColumns(loc[Table.Keccak],
                         tuple(keccak_mod.ctl_data_outputs()),
                         keccak_mod.ctl_filter_outputs()))


def _ctl_sha_extend_sponge(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_sha_extend_sponge_cols()),
                          cpu_ctl.ctl_sha_extend_sponge_filter()),),
        TableWithColumns(loc[Table.ShaExtendSponge],
                         tuple(shaes_mod.ctl_looked_data()),
                         shaes_mod.ctl_looked_filter()))


def _ctl_sha_extend_inputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.ShaExtendSponge],
                          tuple(shaes_mod.ctl_looking_extend_inputs()),
                          shaes_mod.ctl_looking_extend_filter()),),
        TableWithColumns(loc[Table.ShaExtend],
                         tuple(shae_mod.ctl_data_inputs()),
                         shae_mod.ctl_filter()))


def _ctl_sha_extend_outputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.ShaExtendSponge],
                          tuple(shaes_mod.ctl_looking_extend_outputs()),
                          shaes_mod.ctl_looking_extend_filter()),),
        TableWithColumns(loc[Table.ShaExtend],
                         tuple(shae_mod.ctl_data_outputs()),
                         shae_mod.ctl_filter()))


def _ctl_sha_compress_sponge(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.Cpu],
                          tuple(cpu_ctl.ctl_sha_compress_sponge_cols()),
                          cpu_ctl.ctl_sha_compress_sponge_filter()),),
        TableWithColumns(loc[Table.ShaCompressSponge],
                         tuple(shacs_mod.ctl_looked_data()),
                         shacs_mod.ctl_looked_filter()))


def _ctl_sha_compress_inputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.ShaCompressSponge],
                          tuple(shacs_mod.ctl_looking_compress_inputs()),
                          shacs_mod.ctl_looking_compress_filter()),),
        TableWithColumns(loc[Table.ShaCompress],
                         tuple(shac_mod.ctl_data_inputs()),
                         shac_mod.ctl_filter_inputs()))


def _ctl_sha_compress_outputs(loc) -> CrossTableLookup:
    return CrossTableLookup(
        (TableWithColumns(loc[Table.ShaCompressSponge],
                          tuple(shacs_mod.ctl_looking_compress_outputs()),
                          shacs_mod.ctl_looking_compress_filter()),),
        TableWithColumns(loc[Table.ShaCompress],
                         tuple(shac_mod.ctl_data_outputs()),
                         shac_mod.ctl_filter_outputs()))


def _self_ctl(local: int, table: Table) -> CrossTableLookup:
    """A table looking itself up: standalone tables without the CPU."""
    mods = {Table.Arithmetic: arith_mod, Table.Logic: logic_mod,
            Table.Memory: memory_mod}
    if table in mods:
        cols, filt = tuple(mods[table].ctl_data()), mods[table].ctl_filter()
    else:
        cols = tuple(poseidon_mod.ctl_data_inputs())
        filt = poseidon_mod.ctl_filter()
    return CrossTableLookup((TableWithColumns(local, cols, filt),),
                            TableWithColumns(local, cols, filt))


def make_all_stark(subset: Optional[Sequence[Table]] = None) -> AllStark:
    """Build the system over `subset` (default: SPONGE_SUBSET, whose CPU
    table binds PublicValues.roots_before/after by constraint, 16 public
    inputs; FULL_SUBSET is all 12 tables and 15 CTLs).

    With the CPU table present the real CTL topology is used; a subset
    without it gets a self-loop per table (standalone tables)."""
    subset = list(subset) if subset is not None else list(SPONGE_SUBSET)
    missing = [Table(t).name for t in subset if t not in IMPLEMENTED]
    if missing:
        raise NotImplementedError(
            f"table(s) not ported to zkm_tpu_torch yet: {', '.join(missing)}")
    impl = dict(IMPLEMENTED)
    if Table.PoseidonSponge in subset and Table.Cpu in subset:
        impl[Table.Cpu] = CpuStarkImageBound
    starks = [impl[t]() for t in subset]
    loc = {t: i for i, t in enumerate(subset)}

    ctls: List[CrossTableLookup] = []
    if Table.Cpu in loc:
        # reference CTL order: arithmetic, poseidon, keccak, sha extend and
        # sha compress sponge/inputs/outputs, logic, memory
        # (all_stark.rs:136-154)
        if Table.Arithmetic in loc:
            ctls.append(_ctl_arithmetic(loc))
        if Table.PoseidonSponge in loc:
            assert Table.Poseidon in loc, \
                "PoseidonSponge requires the Poseidon table"
            ctls.append(_ctl_poseidon_sponge(loc))
            ctls.append(_ctl_poseidon_inputs(loc))
            ctls.append(_ctl_poseidon_outputs(loc))
        if Table.KeccakSponge in loc:
            assert Table.Keccak in loc, \
                "KeccakSponge requires the Keccak table"
            assert Table.Logic in loc, \
                "KeccakSponge requires the Logic table (absorb XORs)"
            ctls.append(_ctl_keccak_sponge(loc))
            ctls.append(_ctl_keccak_inputs(loc))
            ctls.append(_ctl_keccak_outputs(loc))
        if Table.ShaExtendSponge in loc:
            assert Table.ShaExtend in loc, \
                "ShaExtendSponge requires the ShaExtend table"
            ctls.append(_ctl_sha_extend_sponge(loc))
            ctls.append(_ctl_sha_extend_inputs(loc))
            ctls.append(_ctl_sha_extend_outputs(loc))
        if Table.ShaCompressSponge in loc:
            assert Table.ShaCompress in loc, \
                "ShaCompressSponge requires the ShaCompress table"
            ctls.append(_ctl_sha_compress_sponge(loc))
            ctls.append(_ctl_sha_compress_inputs(loc))
            ctls.append(_ctl_sha_compress_outputs(loc))
        if Table.Logic in loc:
            ctls.append(_ctl_logic(loc))
        if Table.Memory in loc:
            ctls.append(_ctl_memory(loc))
    else:
        ctls = [_self_ctl(local, t) for local, t in enumerate(subset)]
    return AllStark(tables=subset, starks=starks, ctls=ctls)
