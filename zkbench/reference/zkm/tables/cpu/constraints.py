# Frozen copy of zkm_tpu_torch/tables/cpu/constraints.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""CPU constraint groups.

Copy of zkm_tpu/tables/cpu/constraints.py.  Reference: zkMIPS
prover/src/cpu/{bootstrap_kernel,decode,jumps,
membus,memio,shift,count,syscall,bits,misc}.rs — each eval_* below mirrors
the same-named module's packed evaluation, written once against the
polymorphic algebra (symbolic schedule / host extension scalars).

Hardened beyond the reference (see SOUNDNESS.md):
  * the fetched instruction word (code channel value) is bound to the
    opcode/rs/rt/rd/shamt/func bit columns (the reference never links them
    — its ctl_data_code_memory is defined but unused);
  * all instruction bit columns are boolean-constrained (reference: only
    opcode_bits);
  * every op flag is bound to its opcode/func encoding (decode.rs leaves
    classification `// TODO`);
  * pc chaining across consecutive cpu-cycle rows;
  * unused flags (eq_iszero, keccak_general, pc, get/set_context,
    exit_kernel) are pinned to zero.

All constraints have degree <= 3.
"""

from __future__ import annotations

from . import columns as cc

# 2^-32 mod p (jumps.rs GOLDILOCKS_INVERSE_2EXP32)
INV_2EXP32 = 18446744065119617026
P = (1 << 64) - (1 << 32) + 1


def _lfb(a, bits):
    """limb_from_bits_le over a list of algebra values."""
    acc = a.zero
    for i, b in enumerate(bits):
        acc = a.add(acc, a.mul_const(b, 1 << i))
    return acc


def _bits(lv, rng):
    return [lv[i] for i in rng]


def _val(a, lv, rng):
    return _lfb(a, _bits(lv, rng))


def _flag_sum(a, lv):
    acc = a.zero
    for f in cc.OP_FLAGS:
        acc = a.add(acc, lv[f])
    return acc


# ---------------------------------------------------------------------------
# bootstrap_kernel.rs
# ---------------------------------------------------------------------------

def eval_bootstrap(a, lv, nv, consumer):
    one = a.one
    boot = lv[cc.IS_BOOTSTRAP_KERNEL]
    nboot = nv[cc.IS_BOOTSTRAP_KERNEL]
    consumer.constraint_first_row(a.sub(boot, one))
    consumer.constraint_last_row(boot)
    delta = a.sub(nboot, boot)
    consumer.constraint_transition(a.mul(delta, a.add(delta, one)))
    for ch in cc.MEM_CHANNELS:
        filt = a.mul(boot, lv[ch.used])
        consumer.constraint(a.mul(filt, lv[ch.addr_context]))
        consumer.constraint(a.mul(filt, a.sub(lv[ch.addr_segment],
                                              a.constant(0))))  # Code = 0
        # final bootstrap row: all channels disabled
        consumer.constraint_transition(a.mul(delta, lv[ch.used]))

    # exit-kernel padding discipline (exit_kernel.rs eval, last-row half):
    # IS_EXIT_KERNEL ends at 1 and has delta in {0, 1}
    ex = lv[cc.IS_EXIT_KERNEL]
    nex = nv[cc.IS_EXIT_KERNEL]
    consumer.constraint_last_row(a.sub(ex, one))
    consumer.constraint_first_row(ex)
    dex = a.sub(nex, ex)
    consumer.constraint_transition(a.mul(dex, a.sub(dex, one)))
    # the row where is_exit flips pins channel 0's value to the pc
    # (exit_kernel.rs:112-113: the end-pc row's reg-zero write)
    consumer.constraint_transition(a.mul(dex, a.sub(
        lv[cc.MEM_CHANNELS[0].value], lv[cc.PROGRAM_COUNTER])))
    # exit rows freeze the pc
    consumer.constraint_transition(
        a.mul(ex, a.sub(nv[cc.PROGRAM_COUNTER], lv[cc.PROGRAM_COUNTER])))
    # exit-row used channels write ctx 0 / segment Code (exit_kernel.rs:104)
    for ch in cc.MEM_CHANNELS:
        filt = a.mul(ex, lv[ch.used])
        consumer.constraint(a.mul(filt, lv[ch.addr_context]))
        consumer.constraint(a.mul(filt, lv[ch.addr_segment]))


# ---------------------------------------------------------------------------
# PublicValues binding (strengthens bootstrap_kernel.rs:166-174 /
# exit_kernel.rs, where check_image_id is a witness-side assert_eq!).
# ---------------------------------------------------------------------------

# The image-id sponge hashes 9 words at ROOT_HASH_ADDRESS_BASE; its CPU row
# carries (ctx=0, seg=Code=0, virt of the final rate block, len=36) in
# channel values 0..3 and the digest in HASH_VALUE (witness/sponge.py
# _sponge_cpu_row; the poseidon-sponge CTL binds all six to a real sponge
# op over that memory).
IMAGE_ID_LEN = 36
IMAGE_ID_FINAL_BLOCK_VIRT = 0x8102_1000 + 32


def eval_image_id_binding(a, lv, nv, consumer, publics):
    """Bind PublicValues.roots_before/after into the trace.

    publics = 16 scalars: roots_before (8 u32 words) ++ roots_after (8).
    The digest columns are 4 u64 limbs: limb_i = word_{2i} + 2^32 w_{2i+1}.

    Pre side: the bootstrap flag is 1 on row 0 and monotonically falls
    (eval_bootstrap), so `boot - boot'` is 1 on exactly one row — forced
    here to be the pre-image-id sponge row with digest == roots_before.

    Post side: AFTER_IMAGE_ID is boolean, 0 on row 0, monotone, 1 on the
    last row, so it flips exactly once; the flip origin is forced to be
    the post-image-id sponge row with digest == roots_after, and no
    poseidon-sponge row may follow it (a later forged sponge row cannot
    re-claim the binding).
    """
    one = a.one
    shift32 = a.constant(1 << 32)

    def limb(words, i):
        # publics arrive raw (ints / wires / traced scalars); lift per the
        # eval_generic convention (recursion/shrink.py VerifierVmStark)
        return a.add(a.from_base(words[2 * i]),
                     a.mul(shift32, a.from_base(words[2 * i + 1])))

    def pin_image_id_row(sel, words):
        consumer.constraint_transition(
            a.mul(sel, a.sub(lv[cc.IS_POSEIDON_SPONGE], one)))
        consumer.constraint_transition(
            a.mul(sel, lv[cc.MEM_CHANNELS[0].value]))          # ctx = 0
        consumer.constraint_transition(
            a.mul(sel, lv[cc.MEM_CHANNELS[1].value]))          # seg = Code
        consumer.constraint_transition(a.mul(sel, a.sub(
            lv[cc.MEM_CHANNELS[2].value],
            a.constant(IMAGE_ID_FINAL_BLOCK_VIRT))))
        consumer.constraint_transition(a.mul(sel, a.sub(
            lv[cc.MEM_CHANNELS[3].value], a.constant(IMAGE_ID_LEN))))
        for i, c in enumerate(cc.HASH_VALUE):
            consumer.constraint_transition(
                a.mul(sel, a.sub(lv[c], limb(words, i))))

    rb, ra = publics[:8], publics[8:]

    # pre: the single bootstrap 1->0 transition row
    boot_end = a.sub(lv[cc.IS_BOOTSTRAP_KERNEL], nv[cc.IS_BOOTSTRAP_KERNEL])
    pin_image_id_row(boot_end, rb)

    # post: AFTER_IMAGE_ID discipline
    after = lv[cc.AFTER_IMAGE_ID]
    nafter = nv[cc.AFTER_IMAGE_ID]
    consumer.constraint(a.mul(after, a.sub(after, one)))       # boolean
    consumer.constraint_first_row(after)
    consumer.constraint_last_row(a.sub(after, one))
    consumer.constraint_transition(a.mul(after, a.sub(after, nafter)))
    # no sponge rows strictly after the flip origin
    consumer.constraint(a.mul(after, lv[cc.IS_POSEIDON_SPONGE]))

    flip = a.sub(nafter, after)
    consumer.constraint_transition(
        a.mul(flip, a.sub(lv[cc.IS_EXIT_KERNEL], one)))
    pin_image_id_row(flip, ra)


# ---------------------------------------------------------------------------
# decode.rs (+ hardening)
# ---------------------------------------------------------------------------

def eval_decode(a, lv, consumer):
    one = a.one
    kernel = lv[cc.IS_KERNEL_MODE]
    consumer.constraint(a.mul(kernel, a.sub(kernel, one)))

    # booleanity: columns 7..85 are exactly the op flags, branch flags,
    # instruction bits, and sponge filters — one contiguous batch; the
    # bootstrap/exit markers (cols 0-1) are checked individually.
    lo, hi = cc.OP_FLAGS.start, cc.IS_SHA_COMPRESS_SPONGE + 1
    batch = lv.rng(lo, hi)
    consumer.constraint_batch(a.mul(batch, a.sub(batch, one)), hi - lo)
    for c in (cc.IS_BOOTSTRAP_KERNEL, cc.IS_EXIT_KERNEL):
        v = lv[c]
        consumer.constraint(a.mul(v, a.sub(v, one)))

    # at most one op flag per row
    fs = _flag_sum(a, lv)
    consumer.constraint(a.mul(fs, a.sub(fs, one)))

    # fetched instruction word == bit reconstruction (hardening; the code
    # fetch lives in the last GP channel, witness/util.rs:87)
    code_val = lv[cc.MEM_CHANNELS[cc.NUM_GP_CHANNELS - 1].value]
    recon = a.zero
    for base, rng in ((26, cc.OPCODE_BITS), (21, cc.RS_BITS),
                      (16, cc.RT_BITS), (11, cc.RD_BITS),
                      (6, cc.SHAMT_BITS), (0, cc.FUNC_BITS)):
        for i, c in enumerate(rng):
            recon = a.add(recon, a.mul_const(lv[c], 1 << (base + i)))
    consumer.constraint(a.mul(fs, a.sub(code_val, recon)))

    # unused reference flags are pinned to zero
    for f in (cc.OP.eq_iszero, cc.OP.keccak_general, cc.OP.pc,
              cc.OP.get_context, cc.OP.set_context, cc.OP.exit_kernel):
        consumer.constraint(lv[f])


# ---------------------------------------------------------------------------
# flag <-> opcode binding (hardening; decode.rs leaves this TODO)
# ---------------------------------------------------------------------------

# op flag -> opcode + 64*func constant (None = bound elsewhere/CTL)
_FLAG_COMBO = {
    "movz_op": 64 * 0b001010, "movn_op": 64 * 0b001011,
    "clz_op": 0b011100 + 64 * 0b100000, "clo_op": 0b011100 + 64 * 0b100001,
    "ext": 0b011111, "ins": 0b011111 + 64 * 0b000100,
    "maddu": 0b011100 + 64 * 0b000001,
    "rdhwr": 0b011111 + 64 * 0b111011,
    "teq": 64 * 0b110100, "syscall": 64 * 0b001100,
}
_SPECIAL3_SEXT = 0b011111 + 64 * 0b100000   # seh/seb/wsbh share opcode+func


def eval_flag_opcode_binding(a, lv, consumer):
    one = a.one
    combo = a.add(_val(a, lv, cc.OPCODE_BITS),
                  a.mul_const(_val(a, lv, cc.FUNC_BITS), 64))
    opcode_v = _val(a, lv, cc.OPCODE_BITS)
    func_v = _val(a, lv, cc.FUNC_BITS)
    sa_v = _val(a, lv, cc.SHAMT_BITS)
    rs_v = _val(a, lv, cc.RS_BITS)
    rt_v = _val(a, lv, cc.RT_BITS)

    for name, const in _FLAG_COMBO.items():
        flag = lv[getattr(cc.OP, name)]
        consumer.constraint(a.mul(flag, a.sub(combo, a.constant(const))))

    # seh/seb/wsbh: same opcode/func, distinguished by shamt
    for name, sa_const in (("signext16", 0b011000), ("signext8", 0b010000),
                           ("swaphalf", 0b000010)):
        flag = lv[getattr(cc.OP, name)]
        consumer.constraint(
            a.mul(flag, a.sub(combo, a.constant(_SPECIAL3_SEXT))))
        consumer.constraint(a.mul(flag, a.sub(sa_v, a.constant(sa_const))))

    # jumps: func in {8 (JR), 9 (JALR)}, opcode 0
    jumps = lv[cc.OP.jumps]
    consumer.constraint(a.mul(jumps, opcode_v))
    consumer.constraint(a.mul(jumps, a.sub(
        func_v, a.add(a.constant(8), lv[cc.FUNC_BITS.start]))))
    # jumpi: opcode in {2 (J), 3 (JAL)}
    jumpi = lv[cc.OP.jumpi]
    consumer.constraint(a.mul(jumpi, a.sub(
        opcode_v, a.add(a.constant(2), lv[cc.OPCODE_BITS.start]))))
    # jumpdirect (BAL): opcode 1, rt = 0x11, rs = 0
    jd = lv[cc.OP.jumpdirect]
    consumer.constraint(a.mul(jd, a.sub(opcode_v, one)))
    consumer.constraint(a.mul(jd, a.sub(rt_v, a.constant(0x11))))
    consumer.constraint(a.mul(jd, rs_v))

    # branch sub-flag opcode binding
    br = lv[cc.OP.branch]
    for sub, opc in ((cc.BRANCH.is_eq, 4), (cc.BRANCH.is_ne, 5),
                     (cc.BRANCH.is_le, 6), (cc.BRANCH.is_gt, 7),
                     (cc.BRANCH.is_ge, 1), (cc.BRANCH.is_lt, 1)):
        consumer.constraint(
            a.mul(a.mul(br, lv[sub]), a.sub(opcode_v, a.constant(opc))))
    # BGEZ has rt=1, BLTZ rt=0; BLEZ/BGTZ have rt=0
    consumer.constraint(a.mul(a.mul(br, lv[cc.BRANCH.is_ge]),
                              a.sub(rt_v, one)))
    consumer.constraint(a.mul(a.mul(br, lv[cc.BRANCH.is_lt]), rt_v))
    consumer.constraint(a.mul(
        a.mul(br, a.add(lv[cc.BRANCH.is_le], lv[cc.BRANCH.is_gt])), rt_v))

    # nop: SYNC (opcode 0, func 0b001111) or PREF (opcode 0b110011)
    nop = lv[cc.OP.nop]
    consumer.constraint(a.mul(a.mul(nop, opcode_v),
                              a.sub(opcode_v, a.constant(0b110011))))
    consumer.constraint(a.mul(nop, a.mul(
        a.sub(opcode_v, a.constant(0b110011)),
        a.sub(func_v, a.constant(0b001111)))))

    # shift_imm rows have rs = 0 (separates SLL/SRL/SRA from ROR)
    shift_imm = lv[cc.OP.shift_imm]
    for c in cc.RS_BITS:
        consumer.constraint(a.mul(shift_imm, lv[c]))
    # ror: opcode 0, func 0b000010, rs = 1
    ror = lv[cc.OP.ror]
    consumer.constraint(a.mul(ror, opcode_v))
    consumer.constraint(a.mul(ror, a.sub(func_v, a.constant(2))))
    consumer.constraint(a.mul(ror, a.sub(rs_v, one)))


# ---------------------------------------------------------------------------
# pc chaining (hardening; absent from the reference)
# ---------------------------------------------------------------------------

def eval_pc_chain(a, lv, nv, consumer):
    fs_lv = _flag_sum(a, lv)
    fs_nv = _flag_sum(a, nv)
    both = a.mul(fs_lv, fs_nv)
    # every executed row hands pc <- next_pc to the following cycle row
    consumer.constraint_transition(
        a.mul(both, a.sub(nv[cc.PROGRAM_COUNTER],
                          lv[cc.NEXT_PROGRAM_COUNTER])))
    # straight-line ops advance next_pc by 4
    ctl_flow = a.add(a.add(lv[cc.OP.jumps], lv[cc.OP.jumpi]),
                     a.add(lv[cc.OP.jumpdirect], lv[cc.OP.branch]))
    normal = a.sub(fs_lv, ctl_flow)
    consumer.constraint_transition(
        a.mul(a.mul(normal, fs_nv),
              a.sub(nv[cc.NEXT_PROGRAM_COUNTER],
                    a.add_const(lv[cc.NEXT_PROGRAM_COUNTER], 4))))


# ---------------------------------------------------------------------------
# jumps.rs eval_packed_jump_jumpi
# ---------------------------------------------------------------------------

def eval_jumps(a, lv, nv, consumer):
    one = a.one
    is_jump = lv[cc.OP.jumps]
    is_jumpi = lv[cc.OP.jumpi]
    is_jd = lv[cc.OP.jumpdirect]
    is_link = a.mul(is_jump, lv[cc.FUNC_BITS.start])
    is_linki = a.mul(is_jumpi, lv[cc.OPCODE_BITS.start])

    # jump target value/register
    reg_dst = lv[cc.MEM_CHANNELS[0].value]
    consumer.constraint(
        a.mul(is_jump, a.sub(nv[cc.NEXT_PROGRAM_COUNTER], reg_dst)))
    jump_reg = lv[cc.MEM_CHANNELS[0].addr_virtual]
    consumer.constraint(
        a.mul(is_jump, a.sub(_val(a, lv, cc.RS_BITS), jump_reg)))

    # jumpi: dest = (target << 2) + pc_remain (mem channel 2 aux, which the
    # logic CTL binds to pc & 0xf0000000)
    imm_bits = ([a.zero, a.zero] + _bits(lv, cc.FUNC_BITS)
                + _bits(lv, cc.SHAMT_BITS) + _bits(lv, cc.RD_BITS)
                + _bits(lv, cc.RT_BITS) + _bits(lv, cc.RS_BITS))
    imm_dst = _lfb(a, imm_bits)
    pc_remain = lv[cc.MEM_CHANNELS[2].value]
    consumer.constraint(a.mul(is_jumpi, a.sub(
        nv[cc.NEXT_PROGRAM_COUNTER], a.add(pc_remain, imm_dst))))

    # jumpdirect: aux = sign_extended(offset << 2); dest = aux + pc + 4
    aux = lv[cc.MEM_CHANNELS[2].value]
    sign = lv[cc.RD_BITS.start + 4]
    jd_bits = ([a.zero, a.zero] + _bits(lv, cc.FUNC_BITS)
               + _bits(lv, cc.SHAMT_BITS) + _bits(lv, cc.RD_BITS)
               + [sign] * 14)
    consumer.constraint(a.mul(is_jd, a.sub(aux, _lfb(a, jd_bits))))
    jd_dst = a.add(a.add_const(lv[cc.PROGRAM_COUNTER], 4), aux)
    d1 = a.sub(nv[cc.NEXT_PROGRAM_COUNTER], jd_dst)
    d2 = a.sub(a.add_const(nv[cc.NEXT_PROGRAM_COUNTER], 1 << 32), jd_dst)
    consumer.constraint(a.mul(is_jd, a.mul(d1, d2)))

    # link value/register
    link_dst = lv[cc.MEM_CHANNELS[1].value]
    links = a.add(a.add(is_link, is_linki), is_jd)
    consumer.constraint(a.mul(links, a.sub(
        a.add_const(lv[cc.PROGRAM_COUNTER], 8), link_dst)))
    link_reg = lv[cc.MEM_CHANNELS[1].addr_virtual]
    consumer.constraint(
        a.mul(is_link, a.sub(link_reg, _val(a, lv, cc.RD_BITS))))
    consumer.constraint(a.mul(a.add(is_linki, is_jd),
                              a.sub(link_reg, a.constant(31))))


# ---------------------------------------------------------------------------
# jumps.rs eval_packed_branch
# ---------------------------------------------------------------------------

def eval_branch(a, lv, nv, consumer):
    one = a.one
    filt = lv[cc.OP.branch]
    B = cc.BRANCH
    sj = lv[B.should_jump]
    is_eq, is_ne = lv[B.is_eq], lv[B.is_ne]
    is_le, is_gt = lv[B.is_le], lv[B.is_gt]
    is_ge, is_lt = lv[B.is_ge], lv[B.is_lt]
    norm = a.add(a.add(is_eq, is_ne), a.add(is_le, is_gt))
    special = a.add(is_ge, is_lt)
    src1 = lv[cc.MEM_CHANNELS[0].value]
    src2 = lv[cc.MEM_CHANNELS[1].value]
    aux1 = lv[cc.MEM_CHANNELS[2].value]
    aux2 = lv[cc.MEM_CHANNELS[3].value]
    aux3 = lv[cc.MEM_CHANNELS[4].value]
    aux4 = lv[cc.MEM_CHANNELS[5].value]
    ovf = a.constant((1 << 32) % P)

    consumer.constraint(a.mul(sj, a.sub(one, sj)))
    consumer.constraint(a.mul(sj, a.sub(one, filt)))
    consumer.constraint(a.mul(filt, a.sub(one, a.add(norm, special))))
    consumer.constraint(a.mul(filt, a.sub(
        one, a.add(a.add(lv[B.lt], lv[B.gt]), lv[B.eq]))))

    # branch target
    sign = lv[cc.RD_BITS.start + 4]
    off_bits = ([a.zero, a.zero] + _bits(lv, cc.FUNC_BITS)
                + _bits(lv, cc.SHAMT_BITS) + _bits(lv, cc.RD_BITS)
                + [sign] * 14)
    consumer.constraint(a.mul(filt, a.sub(aux4, _lfb(a, off_bits))))
    dst = a.add(a.add_const(lv[cc.PROGRAM_COUNTER], 4), aux4)
    d1 = a.sub(nv[cc.NEXT_PROGRAM_COUNTER], dst)
    d2 = a.sub(a.add(nv[cc.NEXT_PROGRAM_COUNTER], ovf), dst)
    consumer.constraint(a.mul(sj, a.mul(d1, d2)))
    nxt = a.add_const(lv[cc.PROGRAM_COUNTER], 8)
    consumer.constraint(a.mul(a.mul(filt, a.sub(one, sj)),
                              a.sub(nv[cc.NEXT_PROGRAM_COUNTER], nxt)))

    # aux consistency: aux1 = src1-src2 mod 2^32, aux2 = src2-src1 mod 2^32
    ca = a.sub(a.add(aux1, src2), src1)
    consumer.constraint(a.mul(filt, a.mul(ca, a.sub(ca, ovf))))
    cb = a.sub(a.add(aux2, src1), src2)
    consumer.constraint(a.mul(filt, a.mul(cb, a.sub(cb, ovf))))
    consumer.constraint(
        a.mul(filt, a.mul(aux1, a.sub(a.add(aux1, aux2), ovf))))
    consumer.constraint(a.mul(filt, a.mul(aux3, a.sub(one, aux3))))

    # source registers
    rs_reg = lv[cc.MEM_CHANNELS[0].addr_virtual]
    consumer.constraint(
        a.mul(filt, a.sub(rs_reg, _val(a, lv, cc.RS_BITS))))
    rt_reg = lv[cc.MEM_CHANNELS[1].addr_virtual]
    consumer.constraint(
        a.mul(norm, a.sub(rt_reg, _val(a, lv, cc.RT_BITS))))
    consumer.constraint(a.mul(special, a.mul(rt_reg, a.sub(one, rt_reg))))

    # conditions: lt = (src2 + aux1 - src1) * 2^-32, gt symmetric
    lt = a.mul_const(ca, INV_2EXP32)
    consumer.constraint(a.mul(lv[B.lt], a.sub(one, lt)))
    gt = a.mul_const(cb, INV_2EXP32)
    consumer.constraint(a.mul(lv[B.gt], a.sub(one, gt)))
    ne = a.add(lt, gt)
    consumer.constraint(a.mul(lv[B.eq], ne))

    # signed flip when sign bits differ (aux3)
    lt_s = a.add(a.mul(lv[B.lt], a.sub(one, aux3)),
                 a.mul(a.sub(one, lv[B.lt]), aux3))
    gt_s = a.add(a.mul(lv[B.gt], a.sub(one, aux3)),
                 a.mul(a.sub(one, lv[B.gt]), aux3))

    for sub, expect in ((is_eq, a.sub(one, ne)), (is_ne, ne),
                        (is_le, a.sub(one, gt_s)),
                        (is_ge, a.sub(one, lt_s)),
                        (is_gt, gt_s), (is_lt, lt_s)):
        consumer.constraint(a.mul(sub, a.sub(one, filt)))
        consumer.constraint(a.mul(sub, a.sub(sj, expect)))


# ---------------------------------------------------------------------------
# membus.rs
# ---------------------------------------------------------------------------

def eval_membus(a, lv, consumer):
    one = a.one
    consumer.constraint(a.sub(
        lv[cc.CODE_CONTEXT],
        a.mul(a.sub(one, lv[cc.IS_KERNEL_MODE]), lv[cc.CONTEXT])))
    for ch in cc.MEM_CHANNELS:
        used = lv[ch.used]
        consumer.constraint(a.mul(used, a.sub(used, one)))
        # harden: is_read is boolean too (feeds the memory CTL)
        ir = lv[ch.is_read]
        consumer.constraint(a.mul(ir, a.sub(ir, one)))


# ---------------------------------------------------------------------------
# memio.rs
# ---------------------------------------------------------------------------

SEG_REGISTER_FILE = 4


def _sign_ext_bits(a, bits, n):
    """bits[0..n] sign-extended to 32 entries."""
    return bits[:n] + [bits[n - 1]] * (32 - n)


def _enforce_half_word(a, consumer, op, rs_limbs, mem, v1, v0):
    one = a.one
    sa = a.mul(a.sub(rs_limbs[1], one), a.sub(mem, v0))
    sb = a.mul(rs_limbs[1], a.sub(mem, v1))
    consumer.constraint(a.mul(op, a.add(sa, sb)))


def _enforce_byte(a, consumer, lv, op, rs_limbs, mem, v00, v10, v01, v11):
    one = a.one
    aux = lv[cc.IO.aux_rs0_mul_rs1]
    consumer.constraint(
        a.mul(op, a.sub(a.mul(rs_limbs[0], rs_limbs[1]), aux)))
    s = a.add(
        a.add(a.mul(a.sub(mem, v00),
                    a.add(a.sub(a.sub(aux, rs_limbs[1]), rs_limbs[0]), one)),
              a.mul(a.sub(mem, v10), a.sub(aux, rs_limbs[0]))),
        a.add(a.mul(a.sub(mem, v01), a.sub(aux, rs_limbs[1])),
              a.mul(a.sub(mem, v11), aux)))
    consumer.constraint(a.mul(s, op))


def _memio_common(a, lv, consumer, flag_col):
    """Shared address/operand checks for load and store; returns views."""
    one = a.one
    filt = a.mul(lv[flag_col], lv[cc.OPCODE_BITS.start + 5])
    aux_filter = lv[cc.MEMIO.aux_filter]
    consumer.constraint(a.mul(filt, a.sub(one, aux_filter)))

    regfile = a.constant(SEG_REGISTER_FILE)
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_segment], regfile)))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_segment], regfile)))

    rs = lv[cc.MEM_CHANNELS[0].value]
    rt = lv[cc.MEM_CHANNELS[1].value]
    mem = lv[cc.MEM_CHANNELS[3].value]
    rs_limbs = _bits(lv, cc.IO.rs_le)
    rt_limbs = _bits(lv, cc.IO.rt_le)
    mem_limbs = _bits(lv, cc.IO.mem_le)

    # offset = sign-extended imm16 from func||shamt||rd bits (memio.rs:16)
    off_bits = _sign_ext_bits(
        a, _bits(lv, cc.FUNC_BITS) + _bits(lv, cc.SHAMT_BITS)
        + _bits(lv, cc.RD_BITS), 16)
    virt_raw = a.add(rs, _lfb(a, off_bits))
    rs_from_bits = _lfb(a, rs_limbs)
    p32 = a.constant((1 << 32) % P)
    consumer.constraint(a.mul(aux_filter, a.mul(
        a.sub(rs_from_bits, virt_raw),
        a.sub(a.add(rs_from_bits, p32), virt_raw))))
    consumer.constraint(a.mul(filt, a.sub(_lfb(a, rt_limbs), rt)))

    # mem address = virt_raw & ~3
    virt = _lfb(a, [a.zero, a.zero] + rs_limbs[2:])
    consumer.constraint(a.mul(filt, a.sub(
        virt, lv[cc.MEM_CHANNELS[2].addr_virtual])))

    # register indices: rs read ch0, rt ch1 (hardening: memio.rs relies on
    # the CTL value columns only; we pin the register addresses too)
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RT_BITS))))
    return filt, rs, rt, mem, rs_limbs, rt_limbs, mem_limbs


def eval_memio(a, lv, consumer):
    one = a.one
    M = cc.MEMIO
    # sub-flag discipline: each implies its mode flag, exactly one per row
    load_flags = [M.is_lh, M.is_lwl, M.is_lw, M.is_lbu, M.is_lhu, M.is_lwr,
                  M.is_ll, M.is_lb]
    store_flags = [M.is_sb, M.is_sh, M.is_swl, M.is_sw, M.is_swr, M.is_sc,
                   M.is_sdc1]
    for f in load_flags:
        v = lv[f]
        consumer.constraint(a.mul(v, a.sub(v, one)))
        consumer.constraint(a.mul(v, a.sub(one, lv[cc.OP.m_op_load])))
    for f in store_flags:
        v = lv[f]
        consumer.constraint(a.mul(v, a.sub(v, one)))
        consumer.constraint(a.mul(v, a.sub(one, lv[cc.OP.m_op_store])))
    lsum = a.zero
    for f in load_flags:
        lsum = a.add(lsum, lv[f])
    consumer.constraint(a.mul(lv[cc.OP.m_op_load], a.sub(lsum, one)))
    ssum = a.zero
    for f in store_flags:
        ssum = a.add(ssum, lv[f])
    consumer.constraint(a.mul(lv[cc.OP.m_op_store], a.sub(ssum, one)))
    # sub-flag <-> opcode binding (hardening)
    opcode_v = _val(a, lv, cc.OPCODE_BITS)
    subflag_opcode = {
        M.is_lb: 0b100000, M.is_lh: 0b100001, M.is_lwl: 0b100010,
        M.is_lw: 0b100011, M.is_lbu: 0b100100, M.is_lhu: 0b100101,
        M.is_lwr: 0b100110, M.is_ll: 0b110000, M.is_sb: 0b101000,
        M.is_sh: 0b101001, M.is_swl: 0b101010, M.is_sw: 0b101011,
        M.is_swr: 0b101110, M.is_sc: 0b111000, M.is_sdc1: 0b111101,
    }
    for f, opc in subflag_opcode.items():
        consumer.constraint(a.mul(lv[f], a.sub(opcode_v, a.constant(opc))))

    _eval_memio_load(a, lv, consumer)
    _eval_memio_store(a, lv, consumer)


def _eval_memio_load(a, lv, consumer):
    M = cc.MEMIO
    filt, rs, rt, mem, rs_l, rt_l, mem_l = _memio_common(
        a, lv, consumer, cc.OP.m_op_load)

    # LH: sign-extended halfword
    v1 = _lfb(a, _sign_ext_bits(a, mem_l[0:16], 16))
    v0 = _lfb(a, _sign_ext_bits(a, mem_l[16:32], 16))
    _enforce_half_word(a, consumer, lv[M.is_lh], rs_l, mem, v1, v0)

    # LWL
    v00 = _lfb(a, mem_l)
    v10 = _lfb(a, rt_l[0:8] + mem_l[0:24])
    v01 = _lfb(a, rt_l[0:16] + mem_l[0:16])
    v11 = _lfb(a, rt_l[0:24] + mem_l[0:8])
    _enforce_byte(a, consumer, lv, lv[M.is_lwl], rs_l, mem,
                  v00, v10, v01, v11)

    # LW / LL
    mem_val = _lfb(a, mem_l)
    consumer.constraint(a.mul(lv[M.is_lw], a.sub(mem, mem_val)))
    consumer.constraint(a.mul(lv[M.is_ll], a.sub(mem, mem_val)))

    # LBU
    z24 = [a.zero] * 24
    v00 = _lfb(a, mem_l[24:32] + z24)
    v10 = _lfb(a, mem_l[16:24] + z24)
    v01 = _lfb(a, mem_l[8:16] + z24)
    v11 = _lfb(a, mem_l[0:8] + z24)
    _enforce_byte(a, consumer, lv, lv[M.is_lbu], rs_l, mem,
                  v00, v10, v01, v11)

    # LHU
    z16 = [a.zero] * 16
    v1 = _lfb(a, mem_l[0:16] + z16)
    v0 = _lfb(a, mem_l[16:32] + z16)
    _enforce_half_word(a, consumer, lv[M.is_lhu], rs_l, mem, v1, v0)

    # LWR
    v00 = _lfb(a, mem_l[24:32] + rt_l[8:32])
    v10 = _lfb(a, mem_l[16:32] + rt_l[16:32])
    v01 = _lfb(a, mem_l[8:32] + rt_l[24:32])
    v11 = _lfb(a, mem_l)
    _enforce_byte(a, consumer, lv, lv[M.is_lwr], rs_l, mem,
                  v00, v10, v01, v11)

    # LB: sign-extended byte
    v00 = _lfb(a, _sign_ext_bits(a, mem_l[24:32], 8))
    v10 = _lfb(a, _sign_ext_bits(a, mem_l[16:24], 8))
    v01 = _lfb(a, _sign_ext_bits(a, mem_l[8:16], 8))
    v11 = _lfb(a, _sign_ext_bits(a, mem_l[0:8], 8))
    _enforce_byte(a, consumer, lv, lv[M.is_lb], rs_l, mem,
                  v00, v10, v01, v11)


def _eval_memio_store(a, lv, consumer):
    M = cc.MEMIO
    filt, rs, rt, mem, rs_l, rt_l, mem_l = _memio_common(
        a, lv, consumer, cc.OP.m_op_store)

    # SB
    v00 = _lfb(a, mem_l[0:24] + rt_l[0:8])
    v10 = _lfb(a, mem_l[0:16] + rt_l[0:8] + mem_l[24:32])
    v01 = _lfb(a, mem_l[0:8] + rt_l[0:8] + mem_l[16:32])
    v11 = _lfb(a, rt_l[0:8] + mem_l[8:32])
    _enforce_byte(a, consumer, lv, lv[M.is_sb], rs_l, mem,
                  v00, v10, v01, v11)

    # SH
    v0 = _lfb(a, mem_l[0:16] + rt_l[0:16])
    v1 = _lfb(a, rt_l[0:16] + mem_l[16:32])
    _enforce_half_word(a, consumer, lv[M.is_sh], rs_l, mem, v1, v0)

    # SWL
    v00 = _lfb(a, rt_l)
    v10 = _lfb(a, rt_l[8:32] + mem_l[24:32])
    v01 = _lfb(a, rt_l[16:32] + mem_l[16:32])
    v11 = _lfb(a, rt_l[24:32] + mem_l[8:32])
    _enforce_byte(a, consumer, lv, lv[M.is_swl], rs_l, mem,
                  v00, v10, v01, v11)

    # SW / SC
    rt_val = _lfb(a, rt_l)
    consumer.constraint(a.mul(lv[M.is_sw], a.sub(mem, rt_val)))
    consumer.constraint(a.mul(lv[M.is_sc], a.sub(mem, rt_val)))

    # SWR
    v00 = _lfb(a, mem_l[0:24] + rt_l[0:8])
    v10 = _lfb(a, mem_l[0:16] + rt_l[0:16])
    v01 = _lfb(a, mem_l[0:8] + rt_l[0:24])
    v11 = _lfb(a, rt_l)
    _enforce_byte(a, consumer, lv, lv[M.is_swr], rs_l, mem,
                  v00, v10, v01, v11)

    # SDC1 stores zero
    consumer.constraint(a.mul(lv[M.is_sdc1], mem))


# ---------------------------------------------------------------------------
# shift.rs (cpu): shift-table lookup channel
# ---------------------------------------------------------------------------

SEG_SHIFT_TABLE = 3


def eval_shift(a, lv, consumer):
    one = a.one
    seg = a.constant(SEG_SHIFT_TABLE)
    two_exp = cc.MEM_CHANNELS[3]
    for is_shift, disp in (
            (lv[cc.OP.shift], lv[cc.MEM_CHANNELS[0].value]),
            (lv[cc.OP.shift_imm], _val(a, lv, cc.SHAMT_BITS))):
        consumer.constraint(a.mul(
            is_shift, a.mul(lv[two_exp.used], a.sub(lv[two_exp.is_read],
                                                    one))))
        consumer.constraint(a.mul(is_shift, lv[two_exp.addr_context]))
        consumer.constraint(a.mul(is_shift,
                                  a.sub(lv[two_exp.addr_segment], seg)))
        consumer.constraint(a.mul(is_shift,
                                  a.sub(lv[two_exp.addr_virtual], disp)))


# ---------------------------------------------------------------------------
# count.rs: clz/clo
# ---------------------------------------------------------------------------

def eval_count(a, lv, consumer):
    one = a.one
    f_clz = lv[cc.OP.clz_op]
    f_clo = lv[cc.OP.clo_op]
    filt = a.add(f_clz, f_clo)

    # register bindings
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RD_BITS))))

    rs = lv[cc.MEM_CHANNELS[0].value]
    bits = _bits(lv, cc.IO.rs_le)
    for b in bits:
        consumer.constraint(a.mul(filt, a.mul(b, a.sub(one, b))))
    total = _lfb(a, bits)
    consumer.constraint(a.mul(f_clz, a.sub(rs, total)))
    consumer.constraint(a.mul(f_clo, a.sub(
        a.sub(a.constant(0xFFFFFFFF), rs), total)))

    rd = lv[cc.MEM_CHANNELS[1].value]
    is_eqs = _bits(lv, cc.IO.rt_le)
    invs = _bits(lv, cc.IO.mem_le)
    consumer.constraint(a.mul(filt, a.mul(bits[31], rd)))
    k = 0
    for i in range(30, -1, -1):
        partial = _lfb(a, bits[i:])
        is_eq = is_eqs[k]
        inv = invs[k]
        k += 1
        diff = a.sub(partial, one)
        consumer.constraint(a.mul(filt, a.mul(diff, is_eq)))
        consumer.constraint(a.mul(filt, a.sub(
            a.add(a.mul(diff, inv), is_eq), one)))
        consumer.constraint(a.mul(filt, a.mul(
            is_eq, a.sub(rd, a.constant(31 - i)))))
        if i == 0:
            is_eq = is_eqs[k]
            inv = invs[k]
            consumer.constraint(a.mul(filt, a.mul(partial, is_eq)))
            consumer.constraint(a.mul(filt, a.sub(
                a.add(a.mul(partial, inv), is_eq), one)))
            consumer.constraint(a.mul(filt, a.mul(
                is_eq, a.sub(rd, a.constant(32)))))


# ---------------------------------------------------------------------------
# syscall.rs
# ---------------------------------------------------------------------------

def eval_syscall(a, lv, consumer):
    one = a.one
    filt = lv[cc.OP.syscall]
    SC = cc.SYSCALL
    a0 = lv[cc.MEM_CHANNELS[1].value]
    a1v = lv[cc.MEM_CHANNELS[2].value]
    a2v = lv[cc.MEM_CHANNELS[3].value]
    res_v0 = lv[cc.MEM_CHANNELS[4].value]
    res_v1 = lv[cc.MEM_CHANNELS[5].value]
    cond = [lv[SC.cond.start + i] for i in range(12)]
    sysnum = [lv[SC.sysnum.start + i] for i in range(12)]
    a0f = [lv[SC.a0.start + i] for i in range(3)]
    ebadf = a.constant(0xFFFFFFFF)
    v1bad = a.constant(9)   # MIPSEBADF

    # mmap
    is_mmap = sysnum[1]
    sz_nz = lv[SC.a1]                  # sz & 0xfff != 0
    sz_z = sysnum[10]
    sz_rounded = sysnum[9]
    heap = lv[cc.MEM_CHANNELS[6].value]
    res_heap = lv[cc.MEM_CHANNELS[7].value]
    consumer.constraint(a.mul(filt, a.sub(cond[0], a.mul(is_mmap, a0f[0]))))
    consumer.constraint(a.mul(filt, a.sub(cond[1], a.mul(cond[0], sz_nz))))
    consumer.constraint(a.mul(filt, a.mul(cond[1], a.sub(
        a.add(heap, sz_rounded), res_heap))))
    consumer.constraint(a.mul(filt, a.sub(cond[2], a.mul(cond[0], sz_z))))
    consumer.constraint(a.mul(filt, a.mul(cond[2], a.sub(
        a.add(heap, a1v), res_heap))))
    consumer.constraint(a.mul(filt, a.mul(cond[0], a.sub(heap, res_v0))))
    consumer.constraint(a.mul(filt, a.sub(cond[3], a.mul(is_mmap, a0f[2]))))
    consumer.constraint(a.mul(filt, a.mul(cond[3], a.sub(a0, res_v0))))

    # brk: v0 = max(a0, brk) via cond bits
    is_brk = sysnum[2]
    brk0 = lv[cc.MEM_CHANNELS[6].value]
    consumer.constraint(a.mul(filt, a.mul(
        is_brk, a.sub(one, a.add(cond[10], cond[11])))))
    consumer.constraint(a.mul(filt, a.mul(cond[10], a.sub(a0, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(cond[11], a.sub(brk0, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(is_brk, res_v1)))

    # clone: v0 = 1
    is_clone = sysnum[3]
    consumer.constraint(a.mul(filt, a.mul(is_clone, a.sub(one, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(is_clone, res_v1)))

    # read
    is_read = sysnum[5]
    consumer.constraint(a.mul(filt, a.sub(cond[4], a.mul(is_read, a0f[2]))))
    consumer.constraint(a.mul(filt, a.mul(cond[4], a.sub(ebadf, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(cond[4], a.sub(v1bad, res_v1))))
    consumer.constraint(a.mul(filt, a.sub(cond[5], a.mul(is_read, a0f[0]))))
    consumer.constraint(a.mul(filt, a.mul(cond[5], res_v0)))
    consumer.constraint(a.mul(filt, a.mul(cond[5], res_v1)))

    # write
    is_write = sysnum[6]
    consumer.constraint(a.mul(filt, a.sub(cond[6], a.mul(is_write, a0f[2]))))
    consumer.constraint(a.mul(filt, a.mul(cond[6], a.sub(ebadf, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(cond[6], a.sub(v1bad, res_v1))))
    consumer.constraint(a.mul(filt, a.sub(cond[7], a.mul(is_write, a0f[1]))))
    consumer.constraint(a.mul(filt, a.mul(cond[7], a.sub(a2v, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(cond[7], res_v1)))

    # fcntl
    is_fcntl = sysnum[7]
    consumer.constraint(a.mul(filt, a.sub(cond[8], a.mul(is_fcntl, a0f[0]))))
    consumer.constraint(a.mul(filt, a.mul(cond[8], res_v0)))
    consumer.constraint(a.mul(filt, a.mul(cond[8], res_v1)))
    consumer.constraint(a.mul(filt, a.sub(cond[9], a.mul(is_fcntl, a0f[1]))))
    consumer.constraint(a.mul(filt, a.mul(cond[9], a.sub(one, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(cond[9], res_v1)))
    rest = a.sub(a.sub(is_fcntl, cond[8]), cond[9])
    consumer.constraint(a.mul(filt, a.sub(rest, a.mul(is_fcntl, a0f[2]))))
    consumer.constraint(a.mul(filt, a.mul(rest, a.sub(ebadf, res_v0))))
    consumer.constraint(a.mul(filt, a.mul(rest, a.sub(v1bad, res_v1))))

    # set_thread_area: local_user channel = a0
    is_sta = sysnum[8]
    threadarea = lv[cc.MEM_CHANNELS[6].value]
    consumer.constraint(a.mul(filt, a.mul(is_sta, a.sub(a0, threadarea))))


# ---------------------------------------------------------------------------
# bits.rs: seh/seb/wsbh
# ---------------------------------------------------------------------------

def eval_bits(a, lv, consumer):
    one = a.one
    f_seh = lv[cc.OP.signext16]
    f_seb = lv[cc.OP.signext8]
    f_wsbh = lv[cc.OP.swaphalf]
    filt = a.add(a.add(f_seh, f_seb), f_wsbh)

    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RT_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RD_BITS))))

    rt = lv[cc.MEM_CHANNELS[0].value]
    bits = _bits(lv, cc.IO.rt_le)
    for b in bits:
        consumer.constraint(a.mul(filt, a.mul(b, a.sub(one, b))))
    consumer.constraint(a.mul(filt, a.sub(rt, _lfb(a, bits))))

    rd = lv[cc.MEM_CHANNELS[1].value]
    seb = _lfb(a, bits[:7] + [bits[7]] * 25)
    consumer.constraint(a.mul(f_seb, a.sub(rd, seb)))
    seh = _lfb(a, bits[:15] + [bits[15]] * 17)
    consumer.constraint(a.mul(f_seh, a.sub(rd, seh)))
    wsbh = _lfb(a, bits[8:16] + bits[0:8] + bits[24:32] + bits[16:24])
    consumer.constraint(a.mul(f_wsbh, a.sub(rd, wsbh)))


# ---------------------------------------------------------------------------
# misc.rs: rdhwr / condmov / teq / ext / ins / ror / maddu
# ---------------------------------------------------------------------------

def eval_misc(a, lv, consumer):
    one = a.one

    # rdhwr
    filt = lv[cc.OP.rdhwr]
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RT_BITS))))
    rd_index = lv[cc.MISC.rd_index]
    consumer.constraint(a.mul(filt, a.sub(rd_index,
                                          _val(a, lv, cc.RD_BITS))))
    rt_val = lv[cc.MEM_CHANNELS[0].value]
    local_user = lv[cc.MEM_CHANNELS[1].value]
    rd_eq_0 = lv[cc.MISC.rd_index_eq_0]
    rd_eq_29 = lv[cc.MISC.rd_index_eq_29]
    consumer.constraint(a.mul(filt, a.mul(rd_eq_0, rd_index)))
    consumer.constraint(a.mul(filt, a.mul(rd_eq_0, a.sub(rt_val, one))))
    consumer.constraint(a.mul(filt, a.mul(
        rd_eq_29, a.sub(rd_index, a.constant(29)))))
    consumer.constraint(a.mul(filt, a.mul(rd_eq_29,
                                          a.sub(rt_val, local_user))))
    consumer.constraint(a.mul(filt, a.mul(
        a.sub(a.sub(one, rd_eq_29), rd_eq_0), rt_val)))

    # condmov (movz/movn)
    rs = lv[cc.MEM_CHANNELS[0].value]
    rt = lv[cc.MEM_CHANNELS[1].value]
    rd = lv[cc.MEM_CHANNELS[2].value]
    out = lv[cc.MEM_CHANNELS[3].value]
    mov = lv[cc.MEM_CHANNELS[4].value]
    is_movn = lv[cc.OP.movn_op]
    is_movz = lv[cc.OP.movz_op]
    cfilt = a.add(is_movn, is_movz)
    pinv = lv[cc.LOGIC_DIFF_PINV]
    is_ne = a.mul(pinv, rt)
    consumer.constraint(a.mul(is_movn, a.sub(mov, is_ne)))
    consumer.constraint(a.mul(is_movz, a.sub(mov, a.sub(one, is_ne))))
    consumer.constraint(a.mul(cfilt, a.mul(mov, a.sub(one, mov))))
    consumer.constraint(a.mul(cfilt, a.sub(
        out, a.add(a.mul(mov, rs), a.mul(a.sub(one, mov), rd)))))
    # harden the pseudo-inverse: rt != 0 forces the moving branch
    # (movn: mov=1, movz: mov=0) — closes the pinv=0 cheat.
    consumer.constraint(a.mul(is_movn, a.mul(a.sub(one, mov), rt)))
    consumer.constraint(a.mul(is_movz, a.mul(mov, rt)))

    # teq: out = (rs == rt), trap is a no-op (emulator semantics; the
    # reference witness instead errors on equality, operation.rs:2169)
    tfilt = lv[cc.OP.teq]
    t_rs = lv[cc.MEM_CHANNELS[0].value]
    t_rt = lv[cc.MEM_CHANNELS[1].value]
    t_out = lv[cc.MEM_CHANNELS[2].value]
    consumer.constraint(a.mul(tfilt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))
    consumer.constraint(a.mul(tfilt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RT_BITS))))
    diff = a.sub(t_rs, t_rt)
    t_ne = a.mul(diff, pinv)
    # out = 1 - diff*pinv, and out*diff = 0 so diff != 0 forces out = 0
    consumer.constraint(a.mul(tfilt, a.sub(t_out, a.sub(one, t_ne))))
    consumer.constraint(a.mul(tfilt, a.mul(t_out, diff)))

    _eval_ext(a, lv, consumer)
    _eval_ins(a, lv, consumer)
    _eval_ror(a, lv, consumer)
    _eval_maddu(a, lv, consumer)


def _eval_ext(a, lv, consumer):
    one = a.one
    filt = lv[cc.OP.ext]
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RT_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))

    msbd = _val(a, lv, cc.RD_BITS)
    lsb = _val(a, lv, cc.SHAMT_BITS)
    msb = a.add(lsb, msbd)
    rs_bits = _bits(lv, cc.MISC.rs_bits)
    auxm = lv[cc.MISC.auxm]
    auxl = lv[cc.MISC.auxl]
    auxs = lv[cc.MISC.auxs]
    rd_result = lv[cc.MEM_CHANNELS[1].value]
    consumer.constraint(a.mul(filt, a.sub(
        a.add(a.mul(rd_result, auxs), auxl), auxm)))
    for i in range(32):
        mpartial = _lfb(a, rs_bits[:i + 1])
        lpartial = _lfb(a, rs_bits[:i]) if i else a.zero
        is_msb = lv[cc.MISC.is_msb.start + i]
        is_lsb = lv[cc.MISC.is_lsb.start + i]
        consumer.constraint(a.mul(filt, a.mul(
            is_msb, a.sub(msb, a.constant(i)))))
        consumer.constraint(a.mul(filt, a.mul(is_msb,
                                              a.sub(auxm, mpartial))))
        consumer.constraint(a.mul(filt, a.mul(
            is_lsb, a.sub(lsb, a.constant(i)))))
        consumer.constraint(a.mul(filt, a.mul(is_lsb,
                                              a.sub(auxl, lpartial))))
        consumer.constraint(a.mul(filt, a.mul(
            is_lsb, a.sub(auxs, a.constant(1 << i)))))


def _eval_ins(a, lv, consumer):
    filt = lv[cc.OP.ins]
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RT_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[2].addr_virtual], _val(a, lv, cc.RT_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))

    msb = _val(a, lv, cc.RD_BITS)
    lsb = _val(a, lv, cc.SHAMT_BITS)
    rs_bits = _bits(lv, cc.MISC.rs_bits)
    auxm = lv[cc.MISC.auxm]
    auxl = lv[cc.MISC.auxl]
    auxs = lv[cc.MISC.auxs]
    rd_result = lv[cc.MEM_CHANNELS[2].value]
    consumer.constraint(a.mul(filt, a.sub(
        rd_result, a.add(auxm, a.mul(auxl, auxs)))))
    for i in range(32):
        is_msb = lv[cc.MISC.is_msb.start + i]
        is_lsb = lv[cc.MISC.is_lsb.start + i]
        consumer.constraint(a.mul(filt, a.mul(
            is_lsb, a.sub(lsb, a.constant(i)))))
        consumer.constraint(a.mul(filt, a.mul(
            is_lsb, a.sub(auxs, a.constant(1 << i)))))
        consumer.constraint(a.mul(filt, a.mul(
            is_msb, a.sub(a.sub(msb, lsb), a.constant(i)))))
        insert_val = _lfb(a, rs_bits[:i + 1])
        consumer.constraint(a.mul(filt, a.mul(is_msb,
                                              a.sub(auxl, insert_val))))


def _eval_ror(a, lv, consumer):
    filt = lv[cc.OP.ror]
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RD_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RT_BITS))))
    rt_bits = _bits(lv, cc.MISC.rs_bits)
    sa = _val(a, lv, cc.SHAMT_BITS)
    rd_result = lv[cc.MEM_CHANNELS[1].value]
    # harden: the witness bits must decompose the input register
    rt_val = lv[cc.MEM_CHANNELS[0].value]
    one = a.one
    for b in rt_bits:
        consumer.constraint(a.mul(filt, a.mul(b, a.sub(one, b))))
    consumer.constraint(a.mul(filt, a.sub(rt_val, _lfb(a, rt_bits))))
    for i in range(32):
        rd_val = _lfb(a, rt_bits[i:] + rt_bits[:i])
        is_sa = lv[cc.MISC.is_lsb.start + i]
        consumer.constraint(a.mul(filt, a.mul(
            is_sa, a.sub(sa, a.constant(i)))))
        consumer.constraint(a.mul(filt, a.mul(is_sa,
                                              a.sub(rd_result, rd_val))))


def _eval_maddu(a, lv, consumer):
    filt = lv[cc.OP.maddu]
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[0].addr_virtual], _val(a, lv, cc.RS_BITS))))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[1].addr_virtual], _val(a, lv, cc.RT_BITS))))
    hi33 = a.constant(33)
    lo32 = a.constant(32)
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[2].addr_virtual], hi33)))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[4].addr_virtual], hi33)))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[3].addr_virtual], lo32)))
    consumer.constraint(a.mul(filt, a.sub(
        lv[cc.MEM_CHANNELS[5].addr_virtual], lo32)))

    rs = lv[cc.MEM_CHANNELS[0].value]
    rt = lv[cc.MEM_CHANNELS[1].value]
    hi = lv[cc.MEM_CHANNELS[2].value]
    lo = lv[cc.MEM_CHANNELS[3].value]
    hi_res = lv[cc.MEM_CHANNELS[4].value]
    lo_res = lv[cc.MEM_CHANNELS[5].value]
    carry = lv[cc.MISC.auxm]
    scale = a.constant((1 << 32) % P)
    result = a.add(a.mul(hi_res, scale), lo_res)
    mul = a.mul(rs, rt)
    addend = a.add(a.mul(hi, scale), lo)
    overflow = a.mul(carry, scale)
    consumer.constraint(a.mul(filt, a.mul(carry, a.sub(carry, scale))))
    consumer.constraint(a.mul(filt, a.sub(
        a.sub(a.add(mul, addend), overflow), result)))
