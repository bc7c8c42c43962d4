# Frozen copy of zkm_tpu_torch/tables/cpu/ctl.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""CPU-side cross-table-lookup column exports.

Copy of zkm_tpu/tables/cpu/ctl.py.  Reference: zkMIPS
prover/src/cpu/cpu_stark.rs:25-244 — the
arithmetic/logic/memory/sponge looking columns.  Two extra looking tables
strengthen the reference (see the zkm_tpu/witness/generation.py docstring):
`ctl_logic_imm` binds ANDI/ORI/XORI through the logic table, and
`ctl_logic_jumpi` binds the jumpi pc_remain aux value to AND(pc,0xf0000000).
"""

from __future__ import annotations

from typing import List

from ...stark.columns import Column, Filter
from . import columns as cc


def _opcode_func_combo() -> Column:
    """le_bits(opcode_bits ++ func_bits) = opcode + 64*func."""
    return Column.le_bits(list(cc.OPCODE_BITS) + list(cc.FUNC_BITS))


def _mem_time(channel: int = 0) -> Column:
    """clock * NUM_CHANNELS + channel (cpu_stark.rs mem_time_and_channel;
    the reference passes channel 0 for every channel)."""
    return Column.linear_combination_with_constant(
        [(cc.CLOCK, cc.NUM_CHANNELS)], channel)


def _binop_channels() -> List[Column]:
    return [Column.single(cc.MEM_CHANNELS[0].value),
            Column.single(cc.MEM_CHANNELS[1].value),
            Column.single(cc.MEM_CHANNELS[2].value)]


def ctl_arithmetic_base_cols() -> List[Column]:
    return [_opcode_func_combo()] + _binop_channels()


def ctl_arithmetic_base_filter() -> Filter:
    return Filter.new_simple(Column.sum_cols(
        [cc.OP.binary_op, cc.OP.shift, cc.OP.shift_imm]))


def ctl_arithmetic_imm_cols() -> List[Column]:
    return [Column.le_bits(cc.OPCODE_BITS)] + _binop_channels()


def ctl_arithmetic_imm_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.OP.binary_imm_op))


def ctl_logic_cols() -> List[Column]:
    return [_opcode_func_combo()] + _binop_channels()


def ctl_logic_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.OP.logic_op))


def ctl_logic_imm_cols() -> List[Column]:
    """ANDI(12)/ORI(13)/XORI(14) -> AND/OR/XOR consts: 64*opcode + 1536."""
    combo = Column.linear_combination_with_constant(
        [(c, 64 << i) for i, c in enumerate(cc.OPCODE_BITS)], 1536)
    imm = Column.le_bits(list(cc.FUNC_BITS) + list(cc.SHAMT_BITS)
                         + list(cc.RD_BITS))
    return [combo, Column.single(cc.MEM_CHANNELS[0].value), imm,
            Column.single(cc.MEM_CHANNELS[2].value)]


def ctl_logic_imm_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.OP.logic_imm_op))


def ctl_logic_jumpi_cols() -> List[Column]:
    """AND(pc, 0xf0000000) == pc_remain aux (mem channel 2)."""
    return [Column.constant_col(0b100100 << 6),
            Column.single(cc.PROGRAM_COUNTER),
            Column.constant_col(0xF0000000),
            Column.single(cc.MEM_CHANNELS[2].value)]


def ctl_logic_jumpi_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.OP.jumpi))


def ctl_gp_memory_cols(channel: int) -> List[Column]:
    ch = cc.MEM_CHANNELS[channel]
    return [Column.single(ch.is_read), Column.single(ch.addr_context),
            Column.single(ch.addr_segment), Column.single(ch.addr_virtual),
            Column.single(ch.value), _mem_time(0)]


def ctl_gp_memory_filter(channel: int) -> Filter:
    return Filter.new_simple(Column.single(cc.MEM_CHANNELS[channel].used))


# -- sponge CTLs (registered once the sponge tables land) --------------------

def ctl_poseidon_sponge_cols() -> List[Column]:
    cols = [Column.single(cc.MEM_CHANNELS[i].value) for i in range(4)]
    cols.append(_mem_time(0))
    cols.extend(Column.single(c) for c in cc.HASH_VALUE)
    return cols


def ctl_poseidon_sponge_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.IS_POSEIDON_SPONGE))


def ctl_keccak_sponge_cols() -> List[Column]:
    cols = [Column.single(cc.MEM_CHANNELS[i].value) for i in range(4)]
    cols.append(_mem_time(0))
    cols.extend(Column.single(c) for c in cc.KHASH_VALUE)
    return cols


def ctl_keccak_sponge_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.IS_KECCAK_SPONGE))


def ctl_sha_extend_sponge_cols() -> List[Column]:
    cols = [Column.single(cc.MEM_CHANNELS[i].value) for i in range(3)]
    cols.append(_mem_time(0))
    cols.append(Column.single(cc.ELEMENT_VALUE))
    return cols


def ctl_sha_extend_sponge_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.IS_SHA_EXTEND_SPONGE))


def ctl_sha_compress_sponge_cols() -> List[Column]:
    cols = [Column.single(cc.MEM_CHANNELS[i].value) for i in range(3)]
    cols.append(_mem_time(0))
    cols.extend(Column.single(c) for c in cc.SHASH_VALUE)
    return cols


def ctl_sha_compress_sponge_filter() -> Filter:
    return Filter.new_simple(Column.single(cc.IS_SHA_COMPRESS_SPONGE))
