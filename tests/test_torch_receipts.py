"""zkm_tpu_torch's receipts and the SYS_VERIFY path against zkm_tpu: the
cases of tests/test_receipts.py, the composition guest's witness, and
`host.prove_segments_with_assumptions`'s composite receipt, on the CPU.
Equality is exact (tolerance zero)."""

import hashlib

import pytest

from zkm_tpu import receipts as rrc
from zkm_tpu.emulator import state as rstate
from zkm_tpu.emulator import utils as rutils
from zkm_tpu.witness import generation as rgen
from zkm_tpu_torch import host
from zkm_tpu_torch import receipts as rc
from zkm_tpu_torch.emulator import state, utils
from zkm_tpu_torch.runtime import examples
from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
from zkm_tpu_torch.stark.config import StarkConfig
from zkm_tpu_torch.witness import generation, trace_set

CPU = "cpu"

# sys_verify(claim @ 0x1000, 32), then exit_group(0) (tests/test_receipts.py)
VERIFY_PROG = [
    0x8C091000,          # lw t1, 0x1000(zero)
    0x240200F2,          # v0 = SYS_VERIFY
    0x24051000,          # a1 = 0x1000 (claim addr)
    0x24060020,          # a2 = 32
    0x0000000C,          # syscall
    0x24021096, 0x24040000, 0x0000000C,
]
FIB_SUBSET = (Table.Cpu, Table.Logic, Table.Memory)


def _split(prog: bytes, inputs=(), memory=()):
    """(ours, zkm_tpu's) segments of `prog` split at 2^20 cycles."""
    out = []
    for st, split in ((state.State(CPU), utils.split_prog_into_segs),
                      (rstate.State(), rutils.split_prog_into_segs)):
        st.memory.set_memory_range(0, prog)
        for addr, data in memory:
            st.memory.set_memory_range(addr, data)
        for raw in inputs:
            st.add_input_stream_bytes(raw)
        out.append(split(st, None, "", seg_size=1 << 20)[1])
    return out


def _verify_segments(claim: bytes):
    prog = b"".join(w.to_bytes(4, "big") for w in VERIFY_PROG)
    ours, ref = _split(prog, memory=[(0x1000, claim)])
    return ours[0], ref[0]


def _claim(elf_id=b"\x11" * 32, commit=b"\x22" * 32):
    return rc.ReceiptClaim(elf_id=elf_id, commit=commit)


def _proven(claim, package=rc):
    return package.AssumptionReceipt(proven=package.Receipt.segments(
        package.InnerReceipt(segments=[], claim=claim)))


def test_claim_digest():
    c = _claim()
    assert rc.claim_digest(c) == hashlib.sha256(c.elf_id + c.commit).digest()
    assert rc.claim_digest(c) == rrc.claim_digest(
        rrc.ReceiptClaim(c.elf_id, c.commit))


def test_sys_verify_resolves_assumption():
    """The claim is read, resolved and recorded as in zkm_tpu, and the
    whole witness equals zkm_tpu's."""
    claim = _claim()
    digest = rc.claim_digest(claim)
    seg, rseg = _verify_segments(digest)
    proven = _proven(claim)
    t = generation.generate_segment_traces(seg, assumptions=[proven],
                                           device=CPU)
    assert t.claim_digests == [digest]
    assert len(t.assumptions_used) == 1
    assumption, used = t.assumptions_used[0]
    assert assumption == rc.Assumption(digest)
    assert used is proven
    ref = rgen.generate_segment_traces(
        rseg, assumptions=[_proven(rrc.ReceiptClaim(claim.elf_id,
                                                    claim.commit), rrc)])
    assert ref.claim_digests == t.claim_digests
    assert trace_set.field_digests(t) == trace_set.field_digests(ref)


def test_sys_verify_unresolved_raises():
    seg, _ = _verify_segments(b"\x99" * 32)
    with pytest.raises(KeyError, match="Assumption Not Found"):
        generation.generate_segment_traces(seg, assumptions=[], device=CPU)


def test_composition_guest_witness_equals_reference():
    """runtime.examples.build_composition_guest reads the claim digest from
    the hint stream and calls sys_verify on it (tests/test_runtime_guests.py
    :test_composition_guest)."""
    claim = _claim(b"\x07" * 32, b"\x08" * 32)
    digest = rc.claim_digest(claim)
    ours, ref = _split(examples.build_composition_guest(), [digest])
    proven = _proven(claim)
    t = generation.generate_segment_traces(ours[0], sponge=True,
                                           assumptions=[proven], device=CPU)
    assert t.claim_digests == [digest]
    assert t.assumptions_used[0][1] is proven
    r = rgen.generate_segment_traces(
        ref[0], sponge=True,
        assumptions=[_proven(rrc.ReceiptClaim(claim.elf_id, claim.commit),
                             rrc)])
    assert trace_set.field_digests(t) == trace_set.field_digests(r)


class _FakeSeg:
    def __init__(self, pre, post, userdata):
        self.pre_image_id = pre
        self.image_id = post
        self.userdata = userdata


def test_verify_receipt_walks_closure(monkeypatch):
    verified = []
    monkeypatch.setattr(
        "zkm_tpu_torch.host.verify_segment_receipt",
        lambda r, cfg=None, a=None: verified.append(r))
    inner_a = rc.InnerReceipt(
        segments=[_FakeSeg(b"\x11" * 32, b"\x33" * 32, b"\x22" * 32)],
        claim=_claim())
    receipt_a = rc.Receipt.segments(inner_a)
    assumption = rc.Assumption(claim=receipt_a.claim_digest())
    inner_b = rc.InnerReceipt(
        segments=[_FakeSeg(b"\x44" * 32, b"\x55" * 32, b"\x66" * 32)],
        claim=rc.ReceiptClaim(elf_id=b"\x44" * 32, commit=b"\x66" * 32))
    composite = rc.Receipt.composite(rc.CompositeReceipt(
        program_receipt=inner_b,
        assumptions_used=[(assumption,
                           rc.AssumptionReceipt(proven=receipt_a))]))
    rc.verify_receipt(composite)
    assert len(verified) == 2          # program segment + assumption's

    unresolved = rc.Receipt.composite(rc.CompositeReceipt(
        program_receipt=inner_b,
        assumptions_used=[(assumption, rc.AssumptionReceipt(
            unresolved=rc.Assumption(assumption.claim)))]))
    with pytest.raises(ValueError, match="unresolved assumption"):
        rc.verify_receipt(unresolved)
    rc.verify_receipt(unresolved, allow_unresolved=True)

    bad = rc.Receipt.composite(rc.CompositeReceipt(
        program_receipt=inner_b,
        assumptions_used=[(rc.Assumption(b"\x00" * 32),
                           rc.AssumptionReceipt(proven=receipt_a))]))
    with pytest.raises(ValueError, match="digest mismatch"):
        rc.verify_receipt(bad)


def test_split_seg_into_segs_resplit():
    """A segment re-split into smaller ones keeps its ends and its steps,
    with zkm_tpu's image ids (tests/test_receipts.py's loop, 4 rounds
    instead of 1024: a step costs more cycles than the budget, so every
    step is a segment, and each split hashes the memory image on the
    CPU)."""
    prog_words = [
        0x24080000,              # addiu t0, zero, 0
        0x29090004,              # slti t1, t0, 4
        0x1520FFFE,              # bnez t1, -2 insns (loop)
        0x21080001,              # addiu t0, t0, 1 (delay slot)
        0x24021096, 0x24040000, 0x0000000C,
    ]
    prog = b"".join(w.to_bytes(4, "big") for w in prog_words)
    (big,), (rbig,) = _split(prog)
    total, subsegs, _ = utils.split_seg_into_segs(big, seg_size=600,
                                                  device=CPU)
    _, rsubsegs, _ = rutils.split_seg_into_segs(rbig, None, "",
                                                seg_size=600)
    assert len(subsegs) > 1
    assert total == big.step
    assert subsegs[0].pre_image_id == big.pre_image_id
    assert subsegs[-1].image_id == big.image_id
    for x, y in zip(subsegs, subsegs[1:]):
        assert x.image_id == y.pre_image_id
    assert sum(s.step for s in subsegs) == big.step
    assert [(s.step, s.pre_image_id, s.image_id) for s in subsegs] == \
        [(s.step, s.pre_image_id, s.image_id) for s in rsubsegs]


def _composition(claim):
    digest = rc.claim_digest(claim)
    (seg,), _ = _split(examples.build_composition_guest(), [digest])
    return [seg]


def test_prove_segments_with_assumptions_builds_composite(monkeypatch):
    """The receipt's structure, with the proving step stubbed out (the
    slow test below and chip_smoke.py phase 8a prove it): SYS_VERIFY's
    usage makes a Composite receipt whose closure verify_receipt walks,
    and an unresolved assumption fails it."""
    monkeypatch.setattr(host, "prove_trace_set", lambda *a, **k: None)
    monkeypatch.setattr(host, "verify_segment_receipt",
                        lambda *a, **k: None)
    claim = _claim()
    proven = _proven(claim)
    segs = _composition(claim)
    receipt = host.prove_segments_with_assumptions(
        segs, [proven], device=CPU)
    assert isinstance(receipt.inner, rc.CompositeReceipt)
    (assumption, used), = receipt.assumptions()
    assert assumption.claim == rc.claim_digest(claim) and used is proven
    assert receipt.claim().elf_id == segs[0].pre_image_id
    rc.verify_receipt(receipt)
    receipt.inner.assumptions_used[0] = (
        assumption, rc.AssumptionReceipt(unresolved=assumption))
    with pytest.raises(ValueError, match="unresolved"):
        rc.verify_receipt(receipt)
    plain = host.prove_segments_with_assumptions(
        _split(examples.build_fib_guest(3))[0], device=CPU)
    assert isinstance(plain.inner, rc.InnerReceipt)


@pytest.mark.slow
def test_prove_segments_with_assumptions_verifies():
    """The composition guest proved on the CPU (Cpu/Logic/Memory,
    test_config): the composite receipt verifies, and fails with its
    assumption unresolved."""
    config = StarkConfig.test_config()
    all_stark = make_all_stark(FIB_SUBSET)
    claim = _claim()
    receipt = host.prove_segments_with_assumptions(
        _composition(claim), [_proven(claim)], config, all_stark,
        device=CPU)
    rc.verify_receipt(receipt, config, all_stark)
    assumption, _ = receipt.assumptions()[0]
    receipt.inner.assumptions_used[0] = (
        assumption, rc.AssumptionReceipt(unresolved=assumption))
    with pytest.raises(ValueError, match="unresolved"):
        rc.verify_receipt(receipt, config, all_stark)
