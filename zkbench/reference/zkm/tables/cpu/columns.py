# Frozen copy of zkm_tpu_torch/tables/cpu/columns.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""CPU table column layout.

Copy of zkm_tpu/tables/cpu/columns.py.  Reference: zkMIPS
prover/src/cpu/columns/{mod.rs,ops.rs,general.rs}.
The layout mirrors `CpuColumnsView` field for field (reference
NUM_CPU_COLUMNS = 259; ours is 260 — we add AFTER_IMAGE_ID for the
constraint-level PublicValues binding the reference lacks):
system registers, 33 op flags (`OpsColumnsView`), the branch view, the six
instruction bit-decompositions, four sponge filters, the 102-column `general`
union (syscall/logic/shift/io/hash/khash/shash/element/misc views), the memio
view, clock, and 9 general-purpose memory channels of 6 columns each
(membus.rs: NUM_GP_CHANNELS=9, NUM_CHANNELS=10).
"""

from __future__ import annotations


def _rng(start, count):
    return range(start, start + count)


IS_BOOTSTRAP_KERNEL = 0
IS_EXIT_KERNEL = 1
CONTEXT = 2
CODE_CONTEXT = 3
PROGRAM_COUNTER = 4
NEXT_PROGRAM_COUNTER = 5
IS_KERNEL_MODE = 6

# -- op flags (OpsColumnsView, ops.rs) --------------------------------------
_OP_START = 7
OP_NAMES = [
    "binary_op", "binary_imm_op", "eq_iszero", "logic_op", "logic_imm_op",
    "movz_op", "movn_op", "clz_op", "clo_op", "shift", "shift_imm",
    "keccak_general", "jumps", "jumpi", "jumpdirect", "branch", "pc",
    "get_context", "set_context", "exit_kernel", "m_op_load", "m_op_store",
    "nop", "ext", "ins", "maddu", "rdhwr", "signext8", "signext16",
    "swaphalf", "teq", "ror", "syscall",
]
NUM_OPS = len(OP_NAMES)                       # 33


class _View:
    """Attribute access to named column indices."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


OP = _View(**{name: _OP_START + i for i, name in enumerate(OP_NAMES)})
OP_FLAGS = _rng(_OP_START, NUM_OPS)

# -- branch view (CpuBranchView) --------------------------------------------
_BR_START = _OP_START + NUM_OPS               # 40
BRANCH = _View(
    should_jump=_BR_START, gt=_BR_START + 1, lt=_BR_START + 2,
    eq=_BR_START + 3, is_gt=_BR_START + 4, is_lt=_BR_START + 5,
    is_eq=_BR_START + 6, is_ge=_BR_START + 7, is_le=_BR_START + 8,
    is_ne=_BR_START + 9)

# -- instruction bit decompositions (little-endian bit order) ---------------
OPCODE_BITS = _rng(_BR_START + 10, 6)         # insn[31:26]
RS_BITS = _rng(OPCODE_BITS.stop, 5)           # insn[25:21]
RT_BITS = _rng(RS_BITS.stop, 5)               # insn[20:16]
RD_BITS = _rng(RT_BITS.stop, 5)               # insn[15:11]
SHAMT_BITS = _rng(RD_BITS.stop, 5)            # insn[10:6]
FUNC_BITS = _rng(SHAMT_BITS.stop, 6)          # insn[5:0]

IS_POSEIDON_SPONGE = FUNC_BITS.stop           # 82
IS_KECCAK_SPONGE = IS_POSEIDON_SPONGE + 1
IS_SHA_EXTEND_SPONGE = IS_KECCAK_SPONGE + 1
IS_SHA_COMPRESS_SPONGE = IS_SHA_EXTEND_SPONGE + 1

# -- general union (CpuGeneralColumnsView, general.rs) ----------------------
GENERAL_START = IS_SHA_COMPRESS_SPONGE + 1    # 86
NUM_SHARED_COLUMNS = 102                      # size of the misc view

# misc view: rs_bits[32], is_msb[32], is_lsb[32], auxm, auxl, auxs,
#            rd_index, rd_index_eq_0, rd_index_eq_29
MISC = _View(
    rs_bits=_rng(GENERAL_START, 32),
    is_msb=_rng(GENERAL_START + 32, 32),
    is_lsb=_rng(GENERAL_START + 64, 32),
    auxm=GENERAL_START + 96, auxl=GENERAL_START + 97,
    auxs=GENERAL_START + 98, rd_index=GENERAL_START + 99,
    rd_index_eq_0=GENERAL_START + 100, rd_index_eq_29=GENERAL_START + 101)

# io view: rs_le[32], rt_le[32], mem_le[32], aux_rs0_mul_rs1
IO = _View(
    rs_le=_rng(GENERAL_START, 32),
    rt_le=_rng(GENERAL_START + 32, 32),
    mem_le=_rng(GENERAL_START + 64, 32),
    aux_rs0_mul_rs1=GENERAL_START + 96)

# syscall view: cond[12], sysnum[12], a0[3], a1
SYSCALL = _View(
    cond=_rng(GENERAL_START, 12),
    sysnum=_rng(GENERAL_START + 12, 12),
    a0=_rng(GENERAL_START + 24, 3),
    a1=GENERAL_START + 27)

LOGIC_DIFF_PINV = GENERAL_START               # logic view: diff_pinv
SHIFT_HIGH_LIMB_SUM_INV = GENERAL_START       # shift view
HASH_VALUE = _rng(GENERAL_START, 4)           # hash view (poseidon, u64s)
KHASH_VALUE = _rng(GENERAL_START, 8)          # khash view (keccak, u32s)
SHASH_VALUE = _rng(GENERAL_START, 8)          # shash view (sha, u32s)
ELEMENT_VALUE = GENERAL_START                 # element view

# -- memio view (MemIOView) -------------------------------------------------
_MEMIO_START = GENERAL_START + NUM_SHARED_COLUMNS   # 188
MEMIO = _View(
    is_lh=_MEMIO_START, is_lwl=_MEMIO_START + 1, is_lw=_MEMIO_START + 2,
    is_lbu=_MEMIO_START + 3, is_lhu=_MEMIO_START + 4,
    is_lwr=_MEMIO_START + 5, is_sb=_MEMIO_START + 6,
    is_sh=_MEMIO_START + 7, is_swl=_MEMIO_START + 8,
    is_sw=_MEMIO_START + 9, is_swr=_MEMIO_START + 10,
    is_ll=_MEMIO_START + 11, is_sc=_MEMIO_START + 12,
    is_sdc1=_MEMIO_START + 13, is_lb=_MEMIO_START + 14,
    aux_filter=_MEMIO_START + 15)

CLOCK = _MEMIO_START + 16                     # 204

# -- memory channels --------------------------------------------------------
NUM_GP_CHANNELS = 9
NUM_CHANNELS = 10    # timestamp = clock * NUM_CHANNELS (witness/memory.rs:86)
MEM_CH_START = CLOCK + 1                      # 205
MEM_CH_COLS = 6      # used, is_read, addr_context, addr_segment, addr_virtual, value


class MemChannel:
    def __init__(self, i: int):
        base = MEM_CH_START + i * MEM_CH_COLS
        self.used = base
        self.is_read = base + 1
        self.addr_context = base + 2
        self.addr_segment = base + 3
        self.addr_virtual = base + 4
        self.value = base + 5


MEM_CHANNELS = [MemChannel(i) for i in range(NUM_GP_CHANNELS)]

# Monotone 0->1 flag: 1 on every row strictly after the exit kernel's
# post-image-id sponge row.  Its single 0->1 flip designates THE image-id
# sponge row, whose digest columns are bound to PublicValues.roots_after by
# boundary constraints (constraints.py eval_image_id_binding) — the
# constraint-level replacement for the reference's witness-side assert_eq
# (bootstrap_kernel.rs:166-174).  Zero (unconstrained) in subsets without
# the Poseidon sponge chain.
AFTER_IMAGE_ID = MEM_CH_START + NUM_GP_CHANNELS * MEM_CH_COLS    # 259

NUM_CPU_COLUMNS = AFTER_IMAGE_ID + 1                             # 260
assert NUM_CPU_COLUMNS == 260
