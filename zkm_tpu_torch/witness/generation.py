"""Per-instruction witness generation: segment -> CPU rows + table op logs.

Copy of zkm_tpu/witness/generation.py (zkMIPS prover/src/witness/
{transition.rs,operation.rs,util.rs,memory.rs,state.rs} and
generation/mod.rs) for the 12 tables.  Re-executes a segment
instruction by instruction, filling one CPU row per cycle (columns per
tables/cpu/columns.py) and pushing memory / arithmetic / logic / sponge op
logs that become the other tables; returns a `witness.trace_set.TraceSet`.
The VERIFY syscall resolves its claim digest against the assumption
receipts passed in (receipts.py).  Page sponges run on the generation
state's device (witness/sponge.py).

Semantics follow the *emulator* (emulator/state.py) exactly — the
witness must reproduce the segment's post-state — mapped onto the
zkMIPS row/channel discipline:
  * register file ops at (ctx 0, SEG_REGISTER_FILE, reg index), one memory
    op + one CPU channel per access (util.rs reg_read/reg_write_with_log);
  * data/code memory at (ctx 0, SEG_CODE, byte addr);
  * timestamp = clock * NUM_CHANNELS (witness/memory.rs:86);
  * code read fills the last GP channel (util.rs:87);
  * r0 writes and aux values are logged with used=0/filter=false.

Deviations that *strengthen* the reference (documented):
  * ANDI/ORI/XORI push logic-table ops (reference leaves the imm logic
    results unconstrained, operation.rs:304);
  * Jumpi pushes AND(pc, 0xf0000000) to the logic table so the pc_remain
    aux channel is bound (operation.rs:594 leaves it free).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..emulator.state import SHA_COMPRESS_K, Segment, State, sign_extension
from ..field import goldilocks as gl
from ..hash.keccak import keccak256
from ..receipts import Assumption, find_assumption
from ..tables import arithmetic as arith
from ..tables import logic as logic_mod
from ..tables.cpu import columns as cc
from ..tables.memory import (MemoryOp, SEG_CODE, SEG_REGISTER_FILE,
                             SEG_SHIFT_TABLE)
from .sponge import (bootstrap_hash_checks, exit_kernel_checks,
                     keccak_sponge_log, sha_compress_sponge_log,
                     sha_extend_sponge_log)
from .trace_set import TraceSet

M32 = 0xFFFFFFFF
NUM_CHANNELS = cc.NUM_CHANNELS
NUM_GP = cc.NUM_GP_CHANNELS
POSEIDON_RATE_BYTES = 32

# register-file virtual indices (witness/util.rs reg_read_with_log)
REG_LO, REG_HI, REG_HEAP, REG_PC, REG_NEXT_PC, REG_BRK, REG_LOCAL_USER = \
    32, 33, 34, 35, 36, 37, 38
NUM_REGS = 39


def _sein16(v: int) -> int:
    return sign_extension(v & 0xFFFF, 16)


def _rotr(x: int, n: int) -> int:
    x &= M32
    n &= 31
    return ((x >> n) | (x << (32 - n))) & M32


def _finv(x: int) -> int:
    """Field inverse (0 -> 0)."""
    x %= gl.P
    return 0 if x == 0 else gl.host_inv(x)


class GenerationState:
    """Prover-side machine state (generation/state.rs:208-300)."""

    def __init__(self, seg: Segment, device=None, sponge: bool = False,
                 keccak: bool = False, sha: bool = False, assumptions=()):
        self.seg = seg
        self.device = device            # where the page sponges run
        # what SYS_VERIFY resolves claim digests against
        self.assumptions = list(assumptions)
        # which sponge tables are proved: their ops are logged only then,
        # so that a smaller subset's memory CTL stays balanced
        self.sponge_enabled = sponge
        self.keccak_enabled = keccak
        self.sha_enabled = sha
        # registers from the segment's packed register page (state.py)
        st, _ = State.load_seg(seg, device)
        self.regs = list(st.registers) + [
            st.lo, st.hi, st.heap, st.pc, st.next_pc, st.brk, st.local_user]
        self.pc = seg.pc
        self.next_pc = st.next_pc
        self.exited = False
        self.exit_code = 0
        self.is_kernel = True
        self.context = 0
        # sparse word memory keyed by (ctx, segment, virt)
        self.mem: Dict[Tuple[int, int, int], int] = {}
        for i in range(32):
            self.mem[(0, SEG_SHIFT_TABLE, i)] = (1 << i) & M32
        # actual words (mem_image stores byte-swapped LE words)
        self.image: Dict[int, int] = {
            a: int.from_bytes((v & M32).to_bytes(4, "little"), "big")
            for a, v in seg.mem_image.items()}
        self.input_stream = list(seg.input_stream)
        self.input_stream_ptr = seg.input_stream_ptr
        self.public_values_stream = bytearray(seg.public_values_stream)

        # trace accumulators
        self.rows: List[np.ndarray] = []
        self.t = TraceSet(cpu_rows=None)

    # -- memory ---------------------------------------------------------------

    def mget(self, ctx: int, seg: int, virt: int) -> int:
        return self.mem.get((ctx, seg, virt), 0)

    def mset(self, ctx: int, seg: int, virt: int, val: int):
        self.mem[(ctx, seg, virt)] = val & M32

    # -- rows -----------------------------------------------------------------

    def clock(self) -> int:
        return len(self.rows)

    def new_row(self) -> np.ndarray:
        row = np.zeros(cc.NUM_CPU_COLUMNS, dtype=np.uint64)
        row[cc.CLOCK] = self.clock()
        return row

    def push_row(self, row: np.ndarray):
        self.rows.append(row)

    # -- channel / op logging (witness/util.rs) -------------------------------

    def _fill_channel(self, row, n, used, is_read, ctx, seg, virt, val):
        ch = cc.MEM_CHANNELS[n]
        assert row[ch.used] == 0, "channel reused"
        row[ch.used] = used
        row[ch.is_read] = is_read
        row[ch.addr_context] = ctx
        row[ch.addr_segment] = seg
        row[ch.addr_virtual] = virt
        row[ch.value] = val & M32

    def _push_mem(self, filt, is_read, ctx, seg, virt, val):
        self.t.memory_ops.append(MemoryOp(
            filt, self.clock() * NUM_CHANNELS, is_read, ctx, seg, virt,
            val & M32))

    def reg_read(self, index: int, channel: int, row) -> int:
        val = self.regs[index]
        self._fill_channel(row, channel, 1, 1, 0, SEG_REGISTER_FILE, index,
                           val)
        self._push_mem(True, True, 0, SEG_REGISTER_FILE, index, val)
        return val

    def reg_write(self, index: int, channel: int, val: int, row):
        val &= M32
        if index != 0:
            self.regs[index] = val
        used = 0 if index == 0 else 1
        self._fill_channel(row, channel, used, 0, 0, SEG_REGISTER_FILE,
                           index, val)
        self._push_mem(index != 0, False, 0, SEG_REGISTER_FILE, index, val)

    def mem_read_gp(self, channel: int, virt: int, row, seg: int = SEG_CODE,
                    ctx: int = 0) -> int:
        val = self.mget(ctx, seg, virt)
        self._fill_channel(row, channel, 1, 1, ctx, seg, virt, val)
        self._push_mem(True, True, ctx, seg, virt, val)
        return val

    def mem_write_gp(self, channel: int, virt: int, row, val: int,
                     seg: int = SEG_CODE, ctx: int = 0):
        val &= M32
        self._fill_channel(row, channel, 1, 0, ctx, seg, virt, val)
        self._push_mem(True, False, ctx, seg, virt, val)
        self.mset(ctx, seg, virt, val)

    def push_no_write(self, row, channel: int, val: int):
        """Channel value without a memory op (util.rs push_no_write)."""
        ch = cc.MEM_CHANNELS[channel]
        assert row[ch.used] == 0
        row[ch.value] = val & M32

    def read_code(self, row) -> int:
        """Code fetch into the last GP channel + bit decomposition."""
        pc = self.pc
        insn = self.image.get(pc, 0)
        self._fill_channel(row, NUM_GP - 1, 1, 1, 0, SEG_CODE, pc, insn)
        self._push_mem(True, True, 0, SEG_CODE, pc, insn)
        for i in range(6):
            row[cc.OPCODE_BITS.start + i] = (insn >> (26 + i)) & 1
            row[cc.FUNC_BITS.start + i] = (insn >> i) & 1
        for i in range(5):
            row[cc.RS_BITS.start + i] = (insn >> (21 + i)) & 1
            row[cc.RT_BITS.start + i] = (insn >> (16 + i)) & 1
            row[cc.RD_BITS.start + i] = (insn >> (11 + i)) & 1
            row[cc.SHAMT_BITS.start + i] = (insn >> (6 + i)) & 1
        return insn

    # code-segment memory is served from the witness memory dict, which the
    # bootstrap writes populate from the image; reads outside it return 0
    # exactly like MemoryState (witness/memory.rs:150).


def _base_row(s: GenerationState):
    row = s.new_row()
    row[cc.CONTEXT] = s.context
    row[cc.CODE_CONTEXT] = 0 if s.is_kernel else s.context
    row[cc.PROGRAM_COUNTER] = s.pc
    row[cc.NEXT_PROGRAM_COUNTER] = s.next_pc
    row[cc.IS_KERNEL_MODE] = int(s.is_kernel)
    insn = s.read_code(row)
    return row, insn


def _advance(s: GenerationState):
    s.pc = s.next_pc
    s.next_pc = (s.next_pc + 4) & M32


def _jump_to(s: GenerationState, dst: int):
    s.pc = s.next_pc
    s.next_pc = dst & M32


def _set_bits32(row, rng, val):
    for i in range(32):
        row[rng.start + i] = (val >> i) & 1


# ---------------------------------------------------------------------------
# Bootstrap kernel (cpu/bootstrap_kernel.rs:26-72, without the page-hash /
# image-id sponge rows — those land with the PoseidonSponge table).
# ---------------------------------------------------------------------------

def generate_bootstrap(s: GenerationState, sponge: bool = False):
    items = sorted(s.image.items())
    for base in range(0, len(items), 8):
        row = s.new_row()
        row[cc.IS_BOOTSTRAP_KERNEL] = 1
        for channel, (addr, val) in enumerate(items[base:base + 8]):
            s.mem_write_gp(channel, addr, row, val)
        s.push_row(row)
    if sponge:
        bootstrap_hash_checks(s)
    else:
        # terminator: the final bootstrap row must have no used channels
        # (bootstrap_kernel.rs delta constraint); with the PoseidonSponge
        # table this row becomes the image-id sponge row.
        row = s.new_row()
        row[cc.IS_BOOTSTRAP_KERNEL] = 1
        s.push_row(row)


# ---------------------------------------------------------------------------
# Operation generators (witness/operation.rs)
# ---------------------------------------------------------------------------

def _gen_cond_mov(s, row, is_movn, rs, rt, rd):
    row[cc.OP.movn_op if is_movn else cc.OP.movz_op] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    in2 = s.reg_read(rd, 2, row)
    mov = (in1 != 0) if is_movn else (in1 == 0)
    out = in0 if mov else in2
    row[cc.LOGIC_DIFF_PINV] = _finv(in1)
    s.reg_write(rd, 3, out, row)
    s.reg_write(0, 4, int(mov), row)
    s.push_row(row)
    _advance(s)


def _gen_count(s, row, is_clo, rs, rd):
    row[cc.OP.clo_op if is_clo else cc.OP.clz_op] = 1
    in0 = s.reg_read(rs, 0, row)
    x = (~in0 & M32) if is_clo else in0
    out = 32
    for i in range(31, -1, -1):
        if (x >> i) & 1:
            out = 31 - i
            break
    s.reg_write(rd, 1, out, row)
    _set_bits32(row, cc.IO.rs_le, x)
    # conds/invs in rt_le/mem_le (operation.rs generate_count_op)
    k = 0
    for i in range(30, -1, -1):
        part = x >> i
        row[cc.IO.rt_le.start + k] = int(part == 1)
        row[cc.IO.mem_le.start + k] = _finv(part - 1)
        k += 1
    row[cc.IO.rt_le.start + 31] = int(x == 0)
    row[cc.IO.mem_le.start + 31] = _finv(x)
    s.push_row(row)
    _advance(s)


def _gen_logic(s, row, op, rs, rt, rd):
    row[cc.OP.logic_op] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    out = logic_mod.op_result(op, in0, in1)
    s.reg_write(rd, 2, out, row)
    s.t.logic_ops.append((op, in0, in1))
    s.push_row(row)
    _advance(s)


def _gen_logic_imm(s, row, op, rs, rd, imm):
    row[cc.OP.logic_imm_op] = 1
    in0 = s.reg_read(rs, 0, row)
    out = logic_mod.op_result(op, in0, imm)
    s.reg_write(rd, 2, out, row)
    # strengthens the reference: imm logic results go through the table too
    s.t.logic_ops.append((op, in0, imm))
    s.push_row(row)
    _advance(s)


def _gen_arith(s, row, flag, rs, rt, rd):
    row[cc.OP.binary_op] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    op = arith.Op(flag, in0, in1)
    s.reg_write(rd, 2, op.result & M32, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_arith_hilo(s, row, flag, rs, rt):
    row[cc.OP.binary_op] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    op = arith.Op(flag, in0, in1)
    lo, hi = op.lo_hi()
    s.reg_write(REG_LO, 2, lo, row)
    s.reg_write(REG_HI, 3, hi, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_arith_imm(s, row, flag, rs, rt, imm):
    row[cc.OP.binary_imm_op] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = _sein16(imm)
    s.reg_write(rt, 1, in1, row)
    op = arith.Op(flag, in0, in1)
    s.reg_write(rt, 2, op.result & M32, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_lui(s, row, rs, rt, imm):
    row[cc.OP.binary_imm_op] = 1
    in0 = _sein16(imm)
    s.reg_write(rs, 0, in0, row)
    in1 = 1 << 16
    s.reg_write(rt, 1, in1, row)
    op = arith.Op(arith.IS_LUI, in0, in1)
    s.reg_write(rt, 2, op.result & M32, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_shift_imm(s, row, flag, sa, rt, rd):
    row[cc.OP.shift_imm] = 1
    in1 = s.reg_read(rt, 1, row)
    s.push_no_write(row, 0, sa)
    s.mem_read_gp(3, sa, row, seg=SEG_SHIFT_TABLE)
    op = arith.Op(flag, sa, in1)
    s.reg_write(rd, 2, op.result & M32, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_shift_var(s, row, flag, rs, rt, rd):
    row[cc.OP.shift] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    s.mem_read_gp(3, in0, row, seg=SEG_SHIFT_TABLE)
    op = arith.Op(flag, in0, in1)
    s.reg_write(rd, 2, op.result & M32, row)
    s.t.arith_ops.append(op)
    s.push_row(row)
    _advance(s)


def _gen_ror(s, row, rd, rt, sa):
    row[cc.OP.ror] = 1
    in0 = s.reg_read(rt, 0, row)
    out = _rotr(in0, sa)
    _set_bits32(row, cc.MISC.rs_bits, in0)
    row[cc.MISC.is_lsb.start + sa] = 1
    s.reg_write(rd, 1, out, row)
    s.push_row(row)
    _advance(s)


def _gen_jump(s, row, link, target_reg):
    row[cc.OP.jumps] = 1
    target = s.reg_read(target_reg, 0, row)
    s.reg_write(link, 1, (s.pc + 8) & M32, row)
    s.push_row(row)
    _jump_to(s, target)


def _gen_jumpi(s, row, link, target):
    row[cc.OP.jumpi] = 1
    pc_result = s.pc & 0xF0000000
    s.reg_write(0, 2, pc_result, row)
    s.reg_write(link, 1, (s.pc + 8) & M32, row)
    # bind pc_remain via the logic table (strengthens the reference)
    s.t.logic_ops.append((logic_mod.OP_AND, s.pc, 0xF0000000))
    s.push_row(row)
    _jump_to(s, (pc_result + ((target << 2) & 0x0FFFFFFF)) & M32)


def _gen_jumpdirect(s, row, link, offset):
    row[cc.OP.jumpdirect] = 1
    aux = (_sein16(offset) << 2) & M32
    s.reg_write(0, 2, aux, row)
    s.reg_write(link, 1, (s.pc + 8) & M32, row)
    s.push_row(row)
    _jump_to(s, (aux + s.pc + 4) & M32)


_BR_EQ, _BR_NE, _BR_GE, _BR_LE, _BR_GT, _BR_LT = range(6)
_BR_FLAG = {_BR_EQ: "is_eq", _BR_NE: "is_ne", _BR_GE: "is_ge",
            _BR_LE: "is_le", _BR_GT: "is_gt", _BR_LT: "is_lt"}


def _gen_branch(s, row, cond, rs, rt, offset):
    row[cc.OP.branch] = 1
    src1 = s.reg_read(rs, 0, row)
    src2 = s.reg_read(rt, 1, row)
    s1 = src1 - (1 << 32) if src1 >> 31 else src1
    s2 = src2 - (1 << 32) if src2 >> 31 else src2
    should = {_BR_EQ: s1 == s2, _BR_NE: s1 != s2, _BR_GE: s1 >= s2,
              _BR_LE: s1 <= s2, _BR_GT: s1 > s2, _BR_LT: s1 < s2}[cond]
    row[getattr(cc.BRANCH, _BR_FLAG[cond])] = 1
    if src1 == src2:
        row[cc.BRANCH.eq] = 1
    if src1 > src2:
        row[cc.BRANCH.gt] = 1
    if src1 < src2:
        row[cc.BRANCH.lt] = 1
    aux1 = (src1 - src2) & M32
    aux2 = (src2 - src1) & M32
    aux3 = int(((src1 ^ src2) & 0x80000000) != 0)
    aux4 = (_sein16(offset) << 2) & M32
    s.reg_write(0, 2, aux1, row)
    s.reg_write(0, 3, aux2, row)
    s.reg_write(0, 4, aux3, row)
    s.reg_write(0, 5, aux4, row)
    row[cc.BRANCH.should_jump] = int(should)
    s.push_row(row)
    if should:
        _jump_to(s, (aux4 + s.pc + 4) & M32)
    else:
        _jump_to(s, (s.pc + 8) & M32)


def _gen_memio_load(s, row, kind, base, rt_reg, offset):
    row[cc.OP.m_op_load] = 1
    rs = s.reg_read(base, 0, row)
    rt = s.reg_read(rt_reg, 1, row)
    virt_raw = (rs + _sein16(offset)) & M32
    virt = virt_raw & 0xFFFFFFFC
    mem = s.mem_read_gp(2, virt, row)
    _set_bits32(row, cc.IO.mem_le, mem)
    _set_bits32(row, cc.IO.rs_le, virt_raw)
    _set_bits32(row, cc.IO.rt_le, rt)
    row[cc.MEMIO.aux_filter] = row[cc.OP.m_op_load] * \
        row[cc.OPCODE_BITS.start + 5]
    rs0, rs1 = virt_raw & 1, (virt_raw >> 1) & 1
    aux_a = 0
    a = virt_raw
    if kind == "lh":
        row[cc.MEMIO.is_lh] = 1
        val = sign_extension((mem >> (16 - (a & 2) * 8)) & 0xFFFF, 16)
    elif kind == "lwl":
        row[cc.MEMIO.is_lwl] = 1
        sh = (a & 3) * 8
        v = (mem << sh) & M32
        mask = (0xFFFFFFFF << sh) & M32
        val = (rt & (~mask & M32)) | v
        aux_a = rs0 * rs1
    elif kind == "lw":
        row[cc.MEMIO.is_lw] = 1
        val = mem
    elif kind == "lbu":
        row[cc.MEMIO.is_lbu] = 1
        val = (mem >> (24 - (a & 3) * 8)) & 0xFF
        aux_a = rs0 * rs1
    elif kind == "lhu":
        row[cc.MEMIO.is_lhu] = 1
        val = (mem >> (16 - (a & 2) * 8)) & 0xFFFF
    elif kind == "lwr":
        row[cc.MEMIO.is_lwr] = 1
        sh = 24 - (a & 3) * 8
        v = mem >> sh
        mask = 0xFFFFFFFF >> sh
        val = (rt & (~mask & M32)) | v
        aux_a = rs0 * rs1
    elif kind == "ll":
        row[cc.MEMIO.is_ll] = 1
        val = mem
    elif kind == "lb":
        row[cc.MEMIO.is_lb] = 1
        val = sign_extension((mem >> (24 - (a & 3) * 8)) & 0xFF, 8)
        aux_a = rs0 * rs1
    else:
        raise ValueError(kind)
    row[cc.IO.aux_rs0_mul_rs1] = aux_a
    s.reg_write(rt_reg, 3, val, row)
    s.push_row(row)
    _advance(s)


def _gen_memio_store(s, row, kind, base, rt_reg, offset):
    row[cc.OP.m_op_store] = 1
    rs = s.reg_read(base, 0, row)
    rt = s.reg_read(rt_reg, 1, row)
    virt_raw = (rs + _sein16(offset)) & M32
    virt = virt_raw & 0xFFFFFFFC
    mem = s.mem_read_gp(2, virt, row)
    _set_bits32(row, cc.IO.mem_le, mem)
    _set_bits32(row, cc.IO.rs_le, virt_raw)
    _set_bits32(row, cc.IO.rt_le, rt)
    row[cc.MEMIO.aux_filter] = row[cc.OP.m_op_store] * \
        row[cc.OPCODE_BITS.start + 5]
    rs0, rs1 = virt_raw & 1, (virt_raw >> 1) & 1
    aux_a = 0
    a = virt_raw
    if kind == "sb":
        row[cc.MEMIO.is_sb] = 1
        sh = 24 - (a & 3) * 8
        val = (mem & (M32 ^ (0xFF << sh))) | ((rt & 0xFF) << sh)
        aux_a = rs0 * rs1
    elif kind == "sh":
        row[cc.MEMIO.is_sh] = 1
        sh = 16 - (a & 2) * 8
        val = (mem & (M32 ^ (0xFFFF << sh))) | ((rt & 0xFFFF) << sh)
    elif kind == "swl":
        row[cc.MEMIO.is_swl] = 1
        sh = (a & 3) * 8
        v = rt >> sh
        mask = 0xFFFFFFFF >> sh
        val = (mem & (~mask & M32)) | v
        aux_a = rs0 * rs1
    elif kind == "sw":
        row[cc.MEMIO.is_sw] = 1
        val = rt
    elif kind == "swr":
        row[cc.MEMIO.is_swr] = 1
        sh = 24 - (a & 3) * 8
        v = (rt << sh) & M32
        mask = (0xFFFFFFFF << sh) & M32
        val = (mem & (~mask & M32)) | v
        aux_a = rs0 * rs1
    elif kind == "sc":
        row[cc.MEMIO.is_sc] = 1
        val = rt
    elif kind == "sdc1":
        row[cc.MEMIO.is_sdc1] = 1
        val = 0
    else:
        raise ValueError(kind)
    row[cc.IO.aux_rs0_mul_rs1] = aux_a
    s.mem_write_gp(3, virt, row, val)
    if kind == "sc":
        s.reg_write(rt_reg, 4, 1, row)
    s.push_row(row)
    _advance(s)


def _gen_nop(s, row, flag=None):
    if flag is not None:
        row[flag] = 1
    s.push_row(row)
    _advance(s)


def _gen_ext(s, row, rt, rs, msbd, lsb):
    row[cc.OP.ext] = 1
    in0 = s.reg_read(rs, 0, row)
    _set_bits32(row, cc.MISC.rs_bits, in0)
    row[cc.MISC.is_msb.start + msbd + lsb] = 1
    row[cc.MISC.is_lsb.start + lsb] = 1
    row[cc.MISC.auxs] = 1 << lsb
    mask_msb = (1 << (msbd + lsb + 1)) - 1
    mask_lsb = (1 << lsb) - 1
    row[cc.MISC.auxm] = in0 & mask_msb
    row[cc.MISC.auxl] = in0 & mask_lsb
    s.reg_write(rt, 1, (in0 & mask_msb) >> lsb, row)
    s.push_row(row)
    _advance(s)


def _gen_ins(s, row, rt, rs, msb, lsb):
    row[cc.OP.ins] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    mask = (1 << (msb - lsb + 1)) - 1
    mask_field = mask << lsb
    _set_bits32(row, cc.MISC.rs_bits, in0)
    row[cc.MISC.is_msb.start + msb - lsb] = 1
    row[cc.MISC.is_lsb.start + lsb] = 1
    row[cc.MISC.auxm] = in1 & (~mask_field & M32)
    row[cc.MISC.auxl] = in0 & mask
    row[cc.MISC.auxs] = 1 << lsb
    result = (in1 & (~mask_field & M32)) | ((in0 << lsb) & mask_field)
    s.reg_write(rt, 2, result, row)
    s.push_row(row)
    _advance(s)


def _gen_maddu(s, row, rt, rs):
    row[cc.OP.maddu] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    in2 = s.reg_read(REG_HI, 2, row)
    in3 = s.reg_read(REG_LO, 3, row)
    acc = in0 * in1 + ((in2 << 32) | in3)
    overflow = acc >> 64
    result = acc & 0xFFFFFFFFFFFFFFFF
    s.reg_write(REG_HI, 4, (result >> 32) & M32, row)
    s.reg_write(REG_LO, 5, result & M32, row)
    row[cc.MISC.auxm] = (overflow << 32) % gl.P
    s.push_row(row)
    _advance(s)


def _gen_rdhwr(s, row, rt, rd):
    row[cc.OP.rdhwr] = 1
    row[cc.MISC.rd_index] = rd
    if rd == 0:
        row[cc.MISC.rd_index_eq_0] = 1
        result = 1
    elif rd == 29:
        row[cc.MISC.rd_index_eq_29] = 1
        result = s.reg_read(REG_LOCAL_USER, 1, row)
    else:
        result = 0
    s.reg_write(rt, 0, result, row)
    s.push_row(row)
    _advance(s)


def _gen_signext(s, row, rd, rt, bits):
    row[cc.OP.signext8 if bits == 8 else cc.OP.signext16] = 1
    in0 = s.reg_read(rt, 0, row)
    _set_bits32(row, cc.IO.rt_le, in0)
    s.reg_write(rd, 1, sign_extension(in0, bits), row)
    s.push_row(row)
    _advance(s)


def _gen_swaphalf(s, row, rd, rt):
    row[cc.OP.swaphalf] = 1
    in0 = s.reg_read(rt, 0, row)
    _set_bits32(row, cc.IO.rt_le, in0)
    result = ((((in0 >> 16) & 0xFF) << 24) | (((in0 >> 24) & 0xFF) << 16)
              | ((in0 & 0xFF) << 8) | ((in0 >> 8) & 0xFF))
    s.reg_write(rd, 1, result, row)
    s.push_row(row)
    _advance(s)


def _gen_teq(s, row, rs, rt, rd):
    row[cc.OP.teq] = 1
    in0 = s.reg_read(rs, 0, row)
    in1 = s.reg_read(rt, 1, row)
    # emulator semantics: the result (rs == rt) is written to rd
    # (state.py:614-623); the reference witness skips the write.
    row[cc.LOGIC_DIFF_PINV] = _finv(in0 - in1)
    s.reg_write(rd, 2, int(in0 == in1), row)
    s.push_row(row)
    _advance(s)


# ---------------------------------------------------------------------------
# Syscalls (operation.rs generate_syscall:1460-1684) and precompile row
# generators.  Semantics mirror the emulator's _handle_syscall.
# ---------------------------------------------------------------------------

SYSSHAEXTEND = 0x00300105
SYSSHACOMPRESS = 0x00010106
SYSKECCAK = 0x010109
SYSGETPID = 4020
SYSMMAP2 = 4210
SYSMMAP = 4090
SYSBRK = 4045
SYSCLONE = 4120
SYSEXITGROUP = 4246
SYSREAD = 4003
SYSWRITE = 4004
SYSFCNTL = 4055
SYSSETTHREADAREA = 4283
SYSHINTLEN = 0xF0
SYSHINTREAD = 0xF1
SYSVERIFY = 0xF2
FD_STDIN, FD_STDOUT, FD_STDERR, FD_PUBLIC_VALUES, FD_HINT = range(5)
MIPSEBADF = 9

def _gen_syscall(s: GenerationState, row, block_path: str = ""):
    row[cc.OP.syscall] = 1
    sysnum = s.reg_read(2, 0, row)
    a0 = s.reg_read(4, 1, row)
    a1 = s.reg_read(5, 2, row)
    a2 = s.reg_read(6, 3, row)
    v0, v1 = 0, 0
    post = None   # deferred precompile generator
    SC = cc.SYSCALL

    if sysnum == SYSGETPID:
        row[SC.sysnum.start + 0] = 1
        post = lambda: _load_preimage(s, block_path)
    elif sysnum in (SYSMMAP, SYSMMAP2):
        row[SC.sysnum.start + 1] = 1
        sz = a1
        sz_not_aligned = bool(sz & 0xFFF)
        if sz_not_aligned:
            row[SC.a1] = 1
            sz += 0x1000 - (sz & 0xFFF)
            row[SC.sysnum.start + 9] = sz
        else:
            row[SC.sysnum.start + 10] = 1
        if a0 == 0:
            row[SC.cond.start + 0] = 1
            row[SC.a0.start + 0] = 1
            row[SC.cond.start + (1 if sz_not_aligned else 2)] = 1
            heap = s.reg_read(REG_HEAP, 6, row)
            v0 = heap
            s.reg_write(REG_HEAP, 7, (heap + sz) & M32, row)
        else:
            row[SC.cond.start + 3] = 1
            row[SC.a0.start + 2] = 1
            v0 = a0
    elif sysnum == SYSBRK:
        row[SC.sysnum.start + 2] = 1
        brk = s.reg_read(REG_BRK, 6, row)
        if a0 > brk:
            v0 = a0
            row[SC.cond.start + 10] = 1
        else:
            v0 = brk
            row[SC.cond.start + 11] = 1
    elif sysnum == SYSCLONE:
        row[SC.sysnum.start + 3] = 1
        v0 = 1
    elif sysnum == SYSEXITGROUP:
        row[SC.sysnum.start + 4] = 1
        s.exited = True
        s.exit_code = a0 & 0xFF
    elif sysnum == SYSREAD:
        row[SC.sysnum.start + 5] = 1
        if a0 == FD_STDIN:
            row[SC.a0.start + 0] = 1
            row[SC.cond.start + 5] = 1
        else:
            row[SC.a0.start + 2] = 1
            row[SC.cond.start + 4] = 1
            v0, v1 = 0xFFFFFFFF, MIPSEBADF
    elif sysnum == SYSWRITE:
        row[SC.sysnum.start + 6] = 1
        if a0 in (FD_STDOUT, FD_STDERR, FD_HINT):
            row[SC.a0.start + 1] = 1
            row[SC.cond.start + 7] = 1
            v0 = a2
            if a0 == FD_HINT:
                data = _read_mem_bytes(s, a1, a2)
                s.input_stream.append(data)
        elif a0 == FD_PUBLIC_VALUES:
            row[SC.a0.start + 1] = 1
            row[SC.cond.start + 7] = 1
            v0 = a2
            post = lambda: _commit(s, a1, a2)
        else:
            row[SC.a0.start + 2] = 1
            row[SC.cond.start + 6] = 1
            v0, v1 = 0xFFFFFFFF, MIPSEBADF
    elif sysnum == SYSFCNTL:
        row[SC.sysnum.start + 7] = 1
        if a1 == 3:
            if a0 == FD_STDIN:
                row[SC.a0.start + 0] = 1
                row[SC.cond.start + 8] = 1
                v0 = 0
            elif a0 in (FD_STDOUT, FD_STDERR):
                row[SC.a0.start + 1] = 1
                row[SC.cond.start + 9] = 1
                v0 = 1
            else:
                row[SC.a0.start + 2] = 1
                v0, v1 = 0xFFFFFFFF, MIPSEBADF
        elif a1 == 1:
            if a0 in (FD_STDIN, FD_STDOUT, FD_STDERR):
                # the reference witness does not model F_GETFD; mirror the
                # emulator result but mark as "other" (unconstrained path)
                row[SC.sysnum.start + 7] = 0
                row[SC.sysnum.start + 11] = 1
                v0 = a0
            else:
                row[SC.sysnum.start + 7] = 0
                row[SC.sysnum.start + 11] = 1
                v0, v1 = 0xFFFFFFFF, MIPSEBADF
        else:
            row[SC.a0.start + 2] = 1
            v0, v1 = 0xFFFFFFFF, MIPSEBADF
    elif sysnum == SYSSETTHREADAREA:
        row[SC.sysnum.start + 8] = 1
        s.reg_write(REG_LOCAL_USER, 6, a0, row)
    elif sysnum == SYSHINTLEN:
        if s.input_stream_ptr >= len(s.input_stream):
            raise RuntimeError("not enough vecs in hint input stream")
        v0 = len(s.input_stream[s.input_stream_ptr]) & M32
    elif sysnum == SYSHINTREAD:
        vec = s.input_stream[s.input_stream_ptr]
        assert len(vec) == a1, "hint read length mismatch"
        assert a0 % 4 == 0, "hint read address not aligned"
        v0 = a2
        post = lambda: _load_input(s, a0, a1)
    elif sysnum == SYSKECCAK:
        post = lambda: _gen_keccak(s, a0, a1, a2)
    elif sysnum == SYSSHACOMPRESS:
        post = lambda: _gen_sha_compress(s, a0, a1)
    elif sysnum == SYSSHAEXTEND:
        assert a1 == 0, "sha_extend arg2 must be 0"
        post = lambda: _gen_sha_extend(s, a0)
    elif sysnum == SYSVERIFY:
        post = lambda: _verify(s, a1, a2)
    else:
        row[SC.sysnum.start + 11] = 1

    s.reg_write(2, 4, v0, row)
    s.reg_write(7, 5, v1, row)
    s.push_row(row)
    _advance(s)
    if post is not None:
        post()


def _read_mem_bytes(s: GenerationState, addr: int, length: int) -> bytes:
    out = bytearray()
    for i in range(length):
        word = s.mget(0, SEG_CODE, (addr + i) & 0xFFFFFFFC)
        out.append((word >> (24 - ((addr + i) & 3) * 8)) & 0xFF)
    return bytes(out)


def _verify(s: GenerationState, addr: int, size: int):
    """SYS_VERIFY: read the claim digest and resolve it against the
    environment's assumption receipts (operation.rs verify:991-1022)."""
    assert size == 32
    row = s.new_row()
    digest = bytearray()
    for i in range(8):
        v = s.mem_read_gp(i, addr + i * 4, row)
        digest += v.to_bytes(4, "big")
    s.push_row(row)
    digest = bytes(digest)
    s.t.claim_digests.append(digest)
    used = find_assumption(digest, s.assumptions)
    s.t.assumptions_used.insert(0, (Assumption(digest), used))


def _load_input(s: GenerationState, addr: int, size: int):
    """Hint read: write the next input vec to memory (operation.rs:1024)."""
    vec = s.input_stream[s.input_stream_ptr]
    s.input_stream_ptr += 1
    row = s.new_row()
    j = 0
    for i in range(0, size, 4):
        chunk = vec[i:i + 4] + bytes(4 - len(vec[i:i + 4]))
        if j == 8:
            s.push_row(row)
            row = s.new_row()
            j = 0
        s.mem_write_gp(j, addr + i, row, int.from_bytes(chunk, "big"))
        j += 1
    s.push_row(row)


def _commit(s: GenerationState, addr: int, size: int):
    """Public-values commit: read memory into the stream (operation.rs:1069)."""
    row = s.new_row()
    j = 0
    for i in range(0, size, 4):
        if j == 8:
            s.push_row(row)
            row = s.new_row()
            j = 0
        data = s.mem_read_gp(j, addr + i, row)
        ln = size - i if i + 3 >= size else 4
        s.public_values_stream.extend(data.to_bytes(4, "big")[:ln])
        j += 1
    s.push_row(row)


def _load_preimage(s: GenerationState, block_path: str):
    """getpid -> preimage oracle load (operation.rs load_preimage:908)."""
    row = s.new_row()
    hash_bytes = bytearray()
    for i in range(8):
        v = s.mem_read_gp(i, 0x30001000 + i * 4, row)
        hash_bytes += v.to_bytes(4, "big")
    s.push_row(row)
    with open(block_path + "0x" + bytes(hash_bytes).hex(), "rb") as f:
        content = f.read()
    row = s.new_row()
    s.mem_write_gp(0, 0x31000000, row, len(content) & M32)
    map_addr = 0x31000004
    j = 1
    for i in range(0, len(content), 4):
        if j == 8:
            s.push_row(row)
            row = s.new_row()
            j = 0
        ln = min(len(content) - i, 4)
        # little-endian pack + pad10*1 marker (state.rs _load_preimage)
        word = 0
        for k in range(ln):
            word |= content[i + k] << (k * 8)
        if ln < 4:
            end = len(content) % POSEIDON_RATE_BYTES
            word |= 1 << (ln * 8)
            if end + 4 > POSEIDON_RATE_BYTES:
                word |= 0b10000000 << 24
        s.mem_write_gp(j, map_addr, row,
                       int.from_bytes(word.to_bytes(4, "little"), "big"))
        map_addr += 4
        j += 1
    s.push_row(row)


# ---------------------------------------------------------------------------
# Decode + dispatch (witness/transition.rs:42-353)
# ---------------------------------------------------------------------------

_LOGIC_FUNS = {0b100100: logic_mod.OP_AND, 0b100101: logic_mod.OP_OR,
               0b100110: logic_mod.OP_XOR, 0b100111: logic_mod.OP_NOR}
_LOGIC_IMM_OPS = {0b001100: logic_mod.OP_AND, 0b001101: logic_mod.OP_OR,
                  0b001110: logic_mod.OP_XOR}
_ARITH_FUNS = {0b100000: arith.IS_ADD, 0b100001: arith.IS_ADDU,
               0b100010: arith.IS_SUB, 0b100011: arith.IS_SUBU,
               0b101010: arith.IS_SLT, 0b101011: arith.IS_SLTU}
_ARITH_IMM_OPS = {0b001000: arith.IS_ADDI, 0b001001: arith.IS_ADDIU,
                  0b001010: arith.IS_SLTI, 0b001011: arith.IS_SLTIU}
_HILO_FUNS = {0b011000: arith.IS_MULT, 0b011001: arith.IS_MULTU,
              0b011010: arith.IS_DIV, 0b011011: arith.IS_DIVU}
_SHIFT_IMM_FUNS = {0b000000: arith.IS_SLL, 0b000010: arith.IS_SRL,
                   0b000011: arith.IS_SRA}
_SHIFT_VAR_FUNS = {0b000100: arith.IS_SLLV, 0b000110: arith.IS_SRLV,
                   0b000111: arith.IS_SRAV}
_LOAD_OPS = {0b100000: "lb", 0b100001: "lh", 0b100010: "lwl",
             0b100011: "lw", 0b100100: "lbu", 0b100101: "lhu",
             0b100110: "lwr", 0b110000: "ll"}
_STORE_OPS = {0b101000: "sb", 0b101001: "sh", 0b101010: "swl",
              0b101011: "sw", 0b101110: "swr", 0b111000: "sc",
              0b111101: "sdc1"}


def perform_instruction(s: GenerationState, block_path: str = ""):
    """Decode + execute one instruction, pushing its CPU row + ops."""
    row, insn = _base_row(s)
    opcode = insn >> 26
    func = insn & 0x3F
    rt = (insn >> 16) & 0x1F
    rs = (insn >> 21) & 0x1F
    rd = (insn >> 11) & 0x1F
    sa = (insn >> 6) & 0x1F
    offset = insn & 0xFFFF
    target = insn & 0x3FFFFFF

    if opcode == 0:
        if func == 0b001010:
            return _gen_cond_mov(s, row, False, rs, rt, rd)
        if func == 0b001011:
            return _gen_cond_mov(s, row, True, rs, rt, rd)
        if func in _ARITH_FUNS:
            return _gen_arith(s, row, _ARITH_FUNS[func], rs, rt, rd)
        if func in _HILO_FUNS:
            return _gen_arith_hilo(s, row, _HILO_FUNS[func], rs, rt)
        if func in _LOGIC_FUNS:
            return _gen_logic(s, row, _LOGIC_FUNS[func], rs, rt, rd)
        if func == 0b000010 and rs == 1:
            return _gen_ror(s, row, rd, rt, sa)
        if func in _SHIFT_IMM_FUNS:
            return _gen_shift_imm(s, row, _SHIFT_IMM_FUNS[func], sa, rt, rd)
        if func in _SHIFT_VAR_FUNS:
            return _gen_shift_var(s, row, _SHIFT_VAR_FUNS[func], rs, rt, rd)
        if func == 0b010000:   # MFHI
            return _gen_arith(s, row, arith.IS_MFHI, REG_HI, 0, rd)
        if func == 0b010001:   # MTHI
            return _gen_arith(s, row, arith.IS_MTHI, rs, 0, REG_HI)
        if func == 0b010010:   # MFLO
            return _gen_arith(s, row, arith.IS_MFLO, REG_LO, 0, rd)
        if func == 0b010011:   # MTLO
            return _gen_arith(s, row, arith.IS_MTLO, rs, 0, REG_LO)
        if func == 0b001111:   # SYNC
            return _gen_nop(s, row, cc.OP.nop)
        if func == 0x08:       # JR
            return _gen_jump(s, row, 0, rs)
        if func == 0x09:       # JALR
            return _gen_jump(s, row, rd, rs)
        if func == 0b001100:   # SYSCALL
            return _gen_syscall(s, row, block_path)
        if func == 0b110100:   # TEQ
            return _gen_teq(s, row, rs, rt, rd)
        raise ValueError(f"undecodable SPECIAL func {func:#08b} "
                         f"at pc {s.pc:#x}")
    if opcode == 0b011100:     # SPECIAL2
        if func == 0b000010:
            return _gen_arith(s, row, arith.IS_MUL, rs, rt, rd)
        if func == 0b100000:
            return _gen_count(s, row, False, rs, rd)
        if func == 0b100001:
            return _gen_count(s, row, True, rs, rd)
        if func == 0b000001:
            return _gen_maddu(s, row, rt, rs)
        raise ValueError(f"undecodable SPECIAL2 func {func:#08b}")
    if opcode == 0b011111:     # SPECIAL3
        if func == 0b000000:
            return _gen_ext(s, row, rt, rs, rd, sa)
        if func == 0b000100:
            return _gen_ins(s, row, rt, rs, rd, sa)
        if func == 0b111011:
            return _gen_rdhwr(s, row, rt, rd)
        if func == 0b100000:
            if sa == 0b011000:
                return _gen_signext(s, row, rd, rt, 16)
            if sa == 0b010000:
                return _gen_signext(s, row, rd, rt, 8)
            if sa == 0b000010:
                return _gen_swaphalf(s, row, rd, rt)
        raise ValueError(f"undecodable SPECIAL3 func {func:#08b} sa {sa}")
    if opcode == 0x01:
        if rt == 1:
            return _gen_branch(s, row, _BR_GE, rs, 0, offset)
        if rt == 0:
            return _gen_branch(s, row, _BR_LT, rs, 0, offset)
        if rt == 0x11 and rs == 0:
            return _gen_jumpdirect(s, row, 31, offset)
        raise ValueError(f"undecodable regimm rt {rt}")
    if opcode == 0x02:
        return _gen_jumpi(s, row, 0, target)
    if opcode == 0x03:
        return _gen_jumpi(s, row, 31, target)
    if opcode == 0x04:
        return _gen_branch(s, row, _BR_EQ, rs, rt, offset)
    if opcode == 0x05:
        return _gen_branch(s, row, _BR_NE, rs, rt, offset)
    if opcode == 0x06:
        return _gen_branch(s, row, _BR_LE, rs, 0, offset)
    if opcode == 0x07:
        return _gen_branch(s, row, _BR_GT, rs, 0, offset)
    if opcode in _LOAD_OPS:
        return _gen_memio_load(s, row, _LOAD_OPS[opcode], rs, rt, offset)
    if opcode in _STORE_OPS:
        return _gen_memio_store(s, row, _STORE_OPS[opcode], rs, rt, offset)
    if opcode in _ARITH_IMM_OPS:
        return _gen_arith_imm(s, row, _ARITH_IMM_OPS[opcode], rs, rt, offset)
    if opcode in _LOGIC_IMM_OPS:
        return _gen_logic_imm(s, row, _LOGIC_IMM_OPS[opcode], rs, rt, offset)
    if opcode == 0b001111:
        return _gen_lui(s, row, rs, rt, offset)
    if opcode == 0b110011:     # PREF
        return _gen_nop(s, row, cc.OP.nop)
    raise ValueError(f"undecodable opcode {opcode:#08b} at pc {s.pc:#x}")


def _gen_keccak(s: GenerationState, addr: int, length: int, ptr: int):
    """KECCAK syscall rows (operation.rs generate_keccak:1101)."""
    row = s.new_row()
    j = 0
    data = bytearray()
    data_addr = []
    map_addr = addr
    for i in range(0, length, 4):
        if j == 8:
            s.push_row(row)
            row = s.new_row()
            j = 0
        word = s.mem_read_gp(j, map_addr, row)
        ln = min(4, length - i)
        data += word.to_bytes(4, "big")[:ln]
        data_addr.append((0, SEG_CODE, map_addr))
        map_addr += 4
        j += 1
    s.push_row(row)

    row = s.new_row()
    row[cc.IS_KECCAK_SPONGE] = 1
    digest = keccak256(bytes(data))
    row[cc.MEM_CHANNELS[0].value] = 0
    row[cc.MEM_CHANNELS[1].value] = SEG_CODE
    final_idx = (length // 136) * 34
    row[cc.MEM_CHANNELS[2].value] = \
        data_addr[final_idx][2] if final_idx < len(data_addr) else 0
    row[cc.MEM_CHANNELS[3].value] = length
    digest_words = [int.from_bytes(digest[i * 4:i * 4 + 4], "big")
                    for i in range(8)]
    for i, w in enumerate(reversed(digest_words)):
        row[cc.KHASH_VALUE.start + i] = w
    keccak_sponge_log(s, data_addr, bytes(data))
    s.push_row(row)

    row = s.new_row()
    for i in range(8):
        s.mem_write_gp(i, ptr + (i << 2), row, digest_words[i])
    s.push_row(row)


def _gen_sha_extend(s: GenerationState, w_ptr: int):
    """SHA_EXTEND syscall rows (operation.rs generate_sha_extend:1184)."""
    for i in range(16, 64):
        row = s.new_row()
        addrs = []
        # the sigma XORs are proven in-table by the bit-sliced ShaExtend
        # stark (no logic-table ops, unlike zkMIPS — see
        # tables/sha_extend.py)
        w15 = s.mem_read_gp(0, w_ptr + (i - 15) * 4, row)
        addrs.append(w_ptr + (i - 15) * 4)
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        w2 = s.mem_read_gp(1, w_ptr + (i - 2) * 4, row)
        addrs.append(w_ptr + (i - 2) * 4)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w16 = s.mem_read_gp(2, w_ptr + (i - 16) * 4, row)
        addrs.append(w_ptr + (i - 16) * 4)
        w7 = s.mem_read_gp(3, w_ptr + (i - 7) * 4, row)
        addrs.append(w_ptr + (i - 7) * 4)
        w_i = (s1 + w16 + s0 + w7) & M32
        s.mem_write_gp(4, w_ptr + i * 4, row, w_i)
        s.push_row(row)

        row = s.new_row()
        row[cc.IS_SHA_EXTEND_SPONGE] = 1
        row[cc.MEM_CHANNELS[0].value] = 0
        row[cc.MEM_CHANNELS[1].value] = SEG_CODE
        row[cc.MEM_CHANNELS[2].value] = w_ptr + i * 4
        row[cc.ELEMENT_VALUE] = w_i
        sha_extend_sponge_log(s, addrs, [w15, w2, w16, w7],
                              w_ptr + i * 4, i - 16)
        s.push_row(row)


def _gen_sha_compress(s: GenerationState, w_ptr: int, h_ptr: int):
    """SHA_COMPRESS syscall rows (operation.rs generate_sha_compress:1300)."""
    row = s.new_row()
    hx = []
    for i in range(8):
        hx.append(s.mem_read_gp(i, h_ptr + i * 4, row))
    s.push_row(row)

    a, b, c, d, e, f, g, h = hx
    w_vals = []
    state_vals = []
    row = s.new_row()
    j = 0
    for i in range(64):
        state_vals.append([a, b, c, d, e, f, g, h])
        s_1_inter = _rotr(e, 6) ^ _rotr(e, 11)
        s1 = s_1_inter ^ _rotr(e, 25)
        e_not = ~e & M32
        e_and_f = e & f
        not_e_and_g = e_not & g
        ch = e_and_f ^ not_e_and_g
        if j == 8:
            s.push_row(row)
            row = s.new_row()
            j = 0
        w_i = s.mem_read_gp(j, w_ptr + i * 4, row)
        j += 1
        w_vals.append(w_i)
        temp1 = (h + s1 + ch + SHA_COMPRESS_K[i] + w_i) & M32
        s0_inter = _rotr(a, 2) ^ _rotr(a, 13)
        s0 = s0_inter ^ _rotr(a, 22)
        a_and_b = a & b
        a_and_c = a & c
        b_and_c = b & c
        maj_inter = a_and_b ^ a_and_c
        maj = maj_inter ^ b_and_c
        temp2 = (s0 + maj) & M32
        # sigma/ch/maj are proven in-table by the bit-sliced ShaCompress
        # stark (zkMIPS pushes 12 logic ops per round)
        h, g, f, e, d, c, b, a = \
            g, f, e, (d + temp1) & M32, c, b, a, (temp1 + temp2) & M32
    state_vals.append([a, b, c, d, e, f, g, h])
    s.push_row(row)

    row = s.new_row()
    row[cc.IS_SHA_COMPRESS_SPONGE] = 1
    row[cc.MEM_CHANNELS[0].value] = 0
    row[cc.MEM_CHANNELS[1].value] = SEG_CODE
    row[cc.MEM_CHANNELS[2].value] = h_ptr
    out = [(hx[i] + v) & M32
           for i, v in enumerate([a, b, c, d, e, f, g, h])]
    for i, v in enumerate(out):
        row[cc.SHASH_VALUE.start + i] = v
    sha_compress_sponge_log(s, hx, h_ptr, w_vals, w_ptr, state_vals)
    s.push_row(row)

    row = s.new_row()
    for i in range(8):
        s.mem_write_gp(i, h_ptr + i * 4, row, out[i])
    s.push_row(row)


# ---------------------------------------------------------------------------
# Top-level driver (generation/mod.rs simulate_cpu + padding)
# ---------------------------------------------------------------------------

def generate_segment_traces(seg: Segment, block_path: str = "",
                            sponge: bool = False, keccak: bool = False,
                            sha: bool = False, assumptions=(),
                            min_rows: int = 64, device=None) -> TraceSet:
    """Bootstrap + simulate + pad; returns the TraceSet of the tables.
    With `sponge` the page and image-id sponges are generated, on
    `device` (None: the card); with `keccak` / `sha` the ops of the Keccak
    and SHA tables are logged.  SYS_VERIFY resolves its claims against
    `assumptions` (receipts with a `claim_digest()`)."""
    s = GenerationState(seg, device, sponge, keccak, sha, assumptions)
    generate_bootstrap(s, sponge=sponge)

    step = 0
    while True:
        halt = s.is_kernel and (step == seg.step or s.exited)
        if halt:
            if step == seg.step and s.pc != seg.end_pc:
                raise RuntimeError(
                    f"segment split error at {s.pc:#x}, "
                    f"expected {seg.end_pc:#x}")
            exit_kernel_checks(s, seg)
            break
        perform_instruction(s, block_path)
        step += 1

    # padding to a power of two with is_exit_kernel rows
    # (generation/mod.rs:169-185)
    n = max(len(s.rows) + 1, min_rows)
    n = 1 << (n - 1).bit_length()
    pad = np.zeros(cc.NUM_CPU_COLUMNS, dtype=np.uint64)
    pad[cc.CONTEXT] = s.context
    pad[cc.PROGRAM_COUNTER] = s.pc
    pad[cc.NEXT_PROGRAM_COUNTER] = s.next_pc
    pad[cc.IS_EXIT_KERNEL] = 1
    if sponge:
        # every pad row is strictly after the post-image-id sponge row
        # (always >= 1 pad row: n is at least len(rows)+1), flipping
        # AFTER_IMAGE_ID exactly once for the PublicValues binding
        pad[cc.AFTER_IMAGE_ID] = 1
    while len(s.rows) < n:
        row = pad.copy()
        row[cc.CLOCK] = len(s.rows)
        s.rows.append(row)

    s.t.cpu_rows = np.stack(s.rows)
    return s.t

