"""zkm_tpu_torch's emulator and witness generation against zkm_tpu: the
byte sponge, the ELF loader, segment splitting, the guest SDK and the
whole witness of small guests, all on the CPU.  Equality is exact
(tolerance zero).

The frozen record of the memalloc guest's 2^16-cycle segment is made
again with

    python tests/test_torch_emulator.py --write

which runs zkm_tpu's emulator, witness generation and trace builders on
`build_memalloc_guest(64, 64)` (under a minute on a CPU).
"""

import dataclasses
import json
import os
import struct
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

from zkm_tpu import host as rhost  # noqa: E402
from zkm_tpu.emulator import elf as relf  # noqa: E402
from zkm_tpu.emulator import state as rstate  # noqa: E402
from zkm_tpu.emulator import utils as rutils  # noqa: E402
from zkm_tpu.hash import poseidon as rps  # noqa: E402
from zkm_tpu.runtime import examples as rexamples  # noqa: E402
from zkm_tpu.stark import all_stark as rall  # noqa: E402
from zkm_tpu.tables import poseidon_sponge as rpsponge  # noqa: E402
from zkm_tpu.witness import generation as rgen  # noqa: E402
from zkm_tpu_torch import host  # noqa: E402
from zkm_tpu_torch.emulator import elf, state, utils  # noqa: E402
from zkm_tpu_torch.hash import poseidon as ps  # noqa: E402
from zkm_tpu_torch.runtime import examples, guest  # noqa: E402
from zkm_tpu_torch.runtime.asm import Asm  # noqa: E402
from zkm_tpu_torch.stark.all_stark import make_all_stark  # noqa: E402
from zkm_tpu_torch.tables.cpu import columns as cc  # noqa: E402
from zkm_tpu_torch.utils.serialize import U64, bincode_serialize  # noqa: E402
from zkm_tpu_torch.witness import generation, trace_set  # noqa: E402

CPU = "cpu"
MEMALLOC_RECORD = os.path.join(trace_set.DATA,
                               "memalloc_segment_reference.json")
MEMALLOC_ARGS, MEMALLOC_SEG_SIZE = (64, 64), 1 << 16
FIB_N, FIB_SEG_SIZE = 30, 1600        # 3 segments
TOY = b"".join(w.to_bytes(4, "big") for w in (
    0x24080005, 0x2409000A, 0x01095020, 0x3508BEEF, 0x01096824, 0x01097025,
    0xAE2A0000, 0x8E2B0000, 0x24021096, 0x24040000, 0x0000000C))


# ---------------------------------------------------------------------------
# 1. The byte sponge.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 100])
def test_poseidon_bytes_matches_reference(length):
    data = np.random.default_rng(length).bytes(length)
    assert np.array_equal(ps.poseidon_bytes(data, CPU),
                          rps.poseidon_bytes(data))


@pytest.mark.parametrize("npages", [1, 3])
def test_hash_pages_matches_reference(npages):
    pages = np.random.default_rng(npages).integers(
        0, 1 << 32, (npages, 1024), dtype=np.uint32)
    pages[0] = 0
    assert np.array_equal(ps.hash_pages(pages, CPU), rps.hash_pages(pages))


@pytest.mark.parametrize("k,nb", [(1, 3), (5, 4),
                                  (ps.HOST_MAX_STATES + 1, 2)])
def test_sponge_chains_match_reference(k, nb):
    """sponge_chains_u64 gives each permutation's INPUT (rate written,
    capacity carried); chain_states gives the state BEFORE the rate is
    written: each against the reference's own function.  The last case
    takes the plain-torch permutation on the CPU, the others the
    pure-Python one."""
    blocks = np.random.default_rng(k).integers(0, 1 << 32, (k, nb, 8),
                                               dtype=np.uint32)
    inputs, final = ps.sponge_chains_u64(blocks, CPU)
    r_inputs, r_final = rps.sponge_chains_u64(blocks)
    assert np.array_equal(inputs, r_inputs)
    assert np.array_equal(final, r_final)
    pre, post = ps.chain_states(blocks, CPU)
    r_pre, r_post = rpsponge._chain_states(blocks)
    assert np.array_equal(pre, r_pre) and np.array_equal(post, r_post)
    assert not np.array_equal(pre, inputs)


# ---------------------------------------------------------------------------
# 2. The guest SDK.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build,args", [
    ("build_fib_guest", (FIB_N,)), ("build_memalloc_guest", (2, 64)),
    ("build_memalloc_guest", MEMALLOC_ARGS), ("build_sha2_guest", ()),
    ("build_keccak_guest", (32,)), ("build_composition_guest", ())])
def test_guest_sdk_matches_reference(build, args):
    assert getattr(examples, build)(*args) == \
        getattr(rexamples, build)(*args)


# ---------------------------------------------------------------------------
# 3. The ELF loader.
# ---------------------------------------------------------------------------

ELF_VADDR = 0x10000


def minimal_elf(prog: bytes) -> bytes:
    """A 32-bit big-endian MIPS ELF: one PT_LOAD (the program, a word that
    `patch_elf` turns into `jr ra; nop`, a word it zeroes, and a bss tail)
    and a symtab naming those two words."""
    gcenable = ELF_VADDR + len(prog)
    mem_profile = gcenable + 8
    payload = prog + bytes(range(1, 13))
    strtab = b"\x00runtime.gcenable\x00runtime.MemProfileRate\x00"
    symtab = bytes(16) + struct.pack(">IIIBBH", 1, gcenable, 8, 0x12, 0, 1) \
        + struct.pack(">IIIBBH", 18, mem_profile, 4, 0x11, 0, 1)
    ph_off, data_off = 52, 0x100
    sym_off = data_off + len(payload)
    str_off = sym_off + len(symtab)
    sh_off = (str_off + len(strtab) + 3) & ~3
    header = b"\x7fELF" + bytes([1, 2, 1]) + bytes(9) + struct.pack(
        ">HHIIIIIHHHHHH", 2, 8, 1, ELF_VADDR, ph_off, sh_off, 0, 52, 32, 1,
        40, 3, 0)
    phdr = struct.pack(">8I", 1, data_off, ELF_VADDR, ELF_VADDR,
                       len(payload), len(payload) + 64, 5, 0x1000)
    shdrs = bytes(40) + struct.pack(
        ">10I", 0, 2, 0, 0, sym_off, len(symtab), 2, 1, 4, 16) + struct.pack(
        ">10I", 0, 3, 0, 0, str_off, len(strtab), 0, 0, 1, 0)
    out = bytearray(sh_off + len(shdrs))
    for off, part in ((0, header), (ph_off, phdr), (data_off, payload),
                      (sym_off, symtab), (str_off, strtab), (sh_off, shdrs)):
        out[off:off + len(part)] = part
    return bytes(out)


def test_elf_load_matches_reference(tmp_path):
    data = minimal_elf(TOY)
    assert dataclasses.asdict(elf.parse_elf(data)) == \
        dataclasses.asdict(relf.parse_elf(data))
    path = str(tmp_path / "guest.elf")
    with open(path, "wb") as f:
        f.write(data)
    ours = utils.load_elf_with_patch(path, ["x"], CPU)
    ref = rutils.load_elf_with_patch(path, ["x"])
    assert ours.memory.pages == ref.memory.pages
    patched = ours.memory.get_memory(ELF_VADDR + len(TOY))
    assert patched == 0x03E00008
    assert ours.get_registers_bytes() == ref.get_registers_bytes()
    assert (ours.pc, ours.heap, ours.brk) == (ref.pc, ref.heap, ref.brk)
    ist, rist = state.InstrumentedState(ours), rstate.InstrumentedState(ref)
    ist.split_segment(False)
    rist.split_segment(False)
    assert ist.pre_image_id == rist.pre_image_id
    assert ist.pre_hash_root == rist.pre_hash_root


# ---------------------------------------------------------------------------
# 4. Segments of small guests, split by both packages.
# ---------------------------------------------------------------------------

def kitchen_sink_guest() -> bytes:
    """Every mnemonic of runtime/asm.py, both ways of each branch, a hint
    read, a commit, mmap and the other syscalls the witness models."""
    a = Asm()
    guest.hint_len(a)
    a.move("a1", "v0")
    a.li("a0", 0x5000)
    guest.hint_read(a)
    a.li("t0", 0x80000005)
    a.li("t1", 7)
    a.addu("t2", "t0", "t1")
    a.add("t2", "t2", "t1")
    a.subu("t3", "t1", "t0")
    a.sub("t3", "t3", "t1")
    a.and_("t4", "t0", "t1")
    a.or_("t4", "t4", "t2")
    a.xor("t5", "t4", "t3")
    a.nor("t5", "t5", "t1")
    a.slt("t6", "t0", "t1")
    a.sltu("t6", "t0", "t1")
    a.sll("t7", "t0", 3)
    a.srl("t7", "t0", 5)
    a.sra("t7", "t0", 5)
    a.sllv("s1", "t1", "t1")
    a.srlv("s1", "t0", "t1")
    a.mult("t0", "t1")
    a.mfhi("s2")
    a.mflo("s3")
    a.multu("t0", "t1")
    a.div("t0", "t1")
    a.divu("t0", "t1")
    a.mflo("s3")
    a.addiu("s4", "t1", -3)
    a.addi("s4", "s4", 100)
    a.andi("s5", "t0", 0xF0F0)
    a.ori("s5", "s5", 0x1234)
    a.xori("s5", "s5", 0xFFFF)
    a.slti("s6", "t0", -1)
    a.sltiu("s6", "t1", 9)
    a.lui("s7", 0xBEEF)
    a.li("s0", 0x6000)
    a.sw("t0", 0, "s0")
    a.sb("t1", 1, "s0")
    a.sh("t1", 6, "s0")
    a.lw("t2", 0, "s0")
    a.lb("t3", 0, "s0")
    a.lbu("t3", 3, "s0")
    a.lh("t4", 0, "s0")
    a.lhu("t4", 6, "s0")
    a.beq("t1", "t1", "eq_taken")
    a.nop()
    a.nop()
    a.label("eq_taken")
    a.bne("t1", "t1", "eq_taken")
    a.addiu("t1", "t1", 1)              # delay slot of a branch not taken
    a.blez("t0", "blez_taken")
    a.nop()
    a.nop()
    a.label("blez_taken")
    a.bgtz("t0", "blez_taken")
    a.nop()
    a.bgtz("t1", "bgtz_taken")
    a.nop()
    a.nop()
    a.label("bgtz_taken")
    a.blez("t1", "bgtz_taken")
    a.nop()
    a.jal("function")
    a.nop()
    a.j("after")
    a.nop()
    a.label("function")
    a.jr("ra")
    a.addiu("v1", "v1", 1)              # delay slot of jr
    a.label("after")
    for num, args in ((4090, (0x200000, 5000)), (4090, (0, 4096)),
                      (4045, (0, 0)), (4120, (0, 0)), (4283, (0x777, 0)),
                      (4055, (1, 3)), (4055, (0, 1)), (4003, (0, 0)),
                      (4003, (5, 0))):
        a.li("a0", args[0])
        a.li("a1", args[1])
        a.li("v0", num)
        a.syscall()
    a.li("v0", 4004)                    # write(stdout)
    a.li("a0", 1)
    a.li("a1", 0x5000)
    a.li("a2", 3)
    a.syscall()
    guest.commit(a, 0x5000, 10)
    guest.halt(a, 0)
    return a.assemble()


HINT = b"kitchen!:)"


def _states(prog: bytes, inputs=()):
    ours, ref = state.State(CPU), rstate.State()
    for s in (ours, ref):
        s.memory.set_memory_range(0, prog)
        for raw in inputs:
            s.add_input_stream_bytes(raw)
    return ours, ref


GUESTS = {
    # name: (program, input vectors, seg_size)
    "fib": (examples.build_fib_guest(FIB_N), (), FIB_SEG_SIZE),
    "memalloc": (examples.build_memalloc_guest(2, 64),
                 (bincode_serialize([U64(7), U64(1 << 40)]),), 1 << 20),
    "kitchen": (kitchen_sink_guest(), (HINT,), 1 << 20),
}
_SPLITS = {}


def split(name):
    """(ours, reference): each (total steps, segments, final state)."""
    if name not in _SPLITS:
        prog, inputs, seg_size = GUESTS[name]
        ours, ref = _states(prog, inputs)
        _SPLITS[name] = (utils.split_prog_into_segs(ours, seg_size=seg_size),
                         rutils.split_prog_into_segs(ref, seg_size=seg_size))
    return _SPLITS[name]


def assert_segments_equal(segs, rsegs):
    assert len(segs) == len(rsegs)
    for s, r in zip(segs, rsegs):
        assert dataclasses.asdict(s) == dataclasses.asdict(r)
        assert s.to_json() == r.to_json()


@pytest.mark.parametrize("name", sorted(GUESTS))
def test_split_prog_into_segs_matches_reference(name):
    (total, segs, final), (rtotal, rsegs, rfinal) = split(name)
    assert total == rtotal
    assert_segments_equal(segs, rsegs)
    assert final.exited and final.exit_code == rfinal.exit_code == 0
    assert final.public_values_stream == rfinal.public_values_stream
    assert final.input_stream == rfinal.input_stream


def test_fib_splits_into_a_receipt_chain():
    (_, segs, final), _ = split("fib")
    assert len(segs) >= 3
    receipts = [host.SegmentReceipt(None, s.pre_image_id, s.image_id,
                                    host.public_values_for_segment(s).userdata)
                for s in segs]
    host.check_receipt_chain(receipts)
    assert [s.segment_id for s in segs] == list(range(len(segs)))
    assert [s.end_pc for s in segs[:-1]] == [s.pc for s in segs[1:]]
    receipts[1].pre_image_id = bytes(32)
    with pytest.raises(ValueError):
        host.check_receipt_chain(receipts)
    fib = [0, 1]
    for _ in range(FIB_N):
        fib.append((fib[-1] + fib[-2]) & 0xFFFFFFFF)
    assert bytes(final.public_values_stream) == fib[FIB_N].to_bytes(4, "big")


def test_split_seg_into_segs_matches_reference():
    (_, segs, _), _ = split("fib")
    seg = max(segs, key=lambda s: s.step)
    total, parts, _ = utils.split_seg_into_segs(seg, seg_size=1500,
                                                device=CPU)
    rtotal, rparts, _ = rutils.split_seg_into_segs(seg, seg_size=1500)
    assert total == rtotal == seg.step and len(parts) >= 2
    assert_segments_equal(parts, rparts)
    assert parts[0].pre_image_id == seg.pre_image_id
    assert parts[-1].image_id == seg.image_id


def test_input_and_public_values_streams_match_reference():
    """memalloc(2, 64) with a bincode input vector: the input stream and
    userdata pass through the segment, the commit lands in the public
    values stream."""
    (_, segs, final), (_, rsegs, _) = split("memalloc")
    prog, inputs, _ = GUESTS["memalloc"]
    assert segs[0].input_stream == list(inputs) == rsegs[0].input_stream
    acc = 0
    for i in range(2 * 64):
        acc ^= (i * 0x9E3779B1) & 0xFFFFFFFF
    assert bytes(final.public_values_stream) == acc.to_bytes(4, "big")
    assert host.public_values_for_segment(segs[0]) == \
        _plain_pv(rhost.public_values_for_segment(rsegs[0]))
    (_, ksegs, kfinal), _ = split("kitchen")
    assert ksegs[0].input_stream == [HINT]
    assert bytes(kfinal.public_values_stream) == HINT


def _plain_pv(pv):
    from zkm_tpu_torch.stark.proof import MemRoots, PublicValues
    return PublicValues(MemRoots(list(pv.roots_before.root)),
                        MemRoots(list(pv.roots_after.root)),
                        bytes(pv.userdata))


# ---------------------------------------------------------------------------
# 5. Witnesses of those segments.
# ---------------------------------------------------------------------------

_COLUMN_NAMES = {v: k for k, v in vars(cc).items()
                 if isinstance(v, int) and not k.startswith("_")}


def assert_trace_sets_equal(ours, ref):
    """Every npz field of the two witnesses; on a CPU-row mismatch, the
    first differing (row, column)."""
    a, b = trace_set.pack(ours), trace_set.pack(ref)
    assert a.keys() == b.keys()
    rows, rrows = a["cpu_rows"], b["cpu_rows"]
    if rows.shape == rrows.shape and not np.array_equal(rows, rrows):
        r, c = map(int, np.argwhere(rows != rrows)[0])
        pytest.fail(f"cpu_rows differ first at row {r} column {c} "
                    f"({_COLUMN_NAMES.get(c, '?')}): {rows[r, c]} != "
                    f"{rrows[r, c]}")
    for name in a:
        assert a[name].shape == b[name].shape, name
        assert np.array_equal(a[name], b[name]), name


WITNESS_CASES = [("fib", 0), ("fib", 1), ("fib", 2), ("memalloc", 0),
                 ("kitchen", 0)]


@pytest.mark.parametrize("name,index", WITNESS_CASES)
def test_generate_segment_traces_matches_reference(name, index):
    (_, segs, _), (_, rsegs, _) = split(name)
    ours = generation.generate_segment_traces(segs[index], sponge=True,
                                              device=CPU)
    ref = rgen.generate_segment_traces(rsegs[index], sponge=True)
    assert_trace_sets_equal(ours, ref)


def test_toy_segment_from_the_port_emulator_equals_frozen_witness():
    ours, _ = _states(TOY)
    _, segs, _ = utils.split_prog_into_segs(ours, seg_size=1 << 20)
    frozen, pv, _ = trace_set.load_toy_segment()
    fresh = generation.generate_segment_traces(segs[0], sponge=True,
                                               device=CPU)
    assert_trace_sets_equal(fresh, frozen)
    assert host.public_values_for_segment(segs[0]) == pv


def test_unported_syscall_names_its_table():
    """No syscall is left unported: SYS_VERIFY, the last, resolves its
    claim against the assumption receipts (receipts.py) and names the
    claim it cannot find (tests/test_torch_receipts.py holds it against
    zkm_tpu)."""
    assert not hasattr(generation, "_UNPORTED_SYSCALLS")
    ours, _ = _states(examples.build_composition_guest(), (bytes(32),))
    _, segs, _ = utils.split_prog_into_segs(ours, seg_size=1 << 20)
    with pytest.raises(KeyError, match="Assumption Not Found: " + "00" * 32):
        generation.generate_segment_traces(segs[0], sponge=True, device=CPU)


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    (_, segs, _), _ = split("fib")
    seg = segs[-1]
    all_stark = make_all_stark()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host.segment_traces(seg, all_stark)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host.prove_segment(seg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host.prove_elf(str(tmp_path / "missing.elf"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generation.generate_segment_traces(seg, sponge=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.hash_pages(np.zeros((1, 1024), np.uint32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.poseidon_bytes(b"")
    st, _ = state.State.load_seg(seg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.split_prog_into_segs(st, seg_size=1 << 20)


# ---------------------------------------------------------------------------
# 6. The memalloc segment against its frozen record (~1 min on the CPU;
#    on the card `chip_smoke.py` phase 6 runs it in every run).
# ---------------------------------------------------------------------------

def segment_record(seg, ts, heights) -> dict:
    pv = rhost.public_values_for_segment(seg)
    return {
        "step": seg.step, "pc": seg.pc, "end_pc": seg.end_pc,
        "pre_image_id": seg.pre_image_id.hex(),
        "image_id": seg.image_id.hex(),
        "public_values": {
            "roots_before": [int(v) for v in pv.roots_before.root],
            "roots_after": [int(v) for v in pv.roots_after.root],
            "userdata": bytes(pv.userdata).hex()},
        "natural_heights_log2": heights,
        "field_digests": trace_set.field_digests(ts),
    }


def run_memalloc(device):
    """(total steps, segments, TraceSets) of the memalloc guest through the
    port on `device`."""
    st = state.State(device)
    st.memory.set_memory_range(0, examples.build_memalloc_guest(
        *MEMALLOC_ARGS))
    total, segs, _ = utils.split_prog_into_segs(st,
                                                seg_size=MEMALLOC_SEG_SIZE)
    return total, segs, [generation.generate_segment_traces(
        s, sponge=True, device=device) for s in segs]


@pytest.mark.slow
def test_memalloc_segment_matches_frozen_record():
    with open(MEMALLOC_RECORD) as f:
        record = json.load(f)
    total, segs, tss = run_memalloc(CPU)
    assert (total, len(segs)) == (record["total_steps"],
                                  record["num_segments"])
    for seg, ts, want in zip(segs, tss, record["segments"]):
        got = segment_record(seg, ts, want["natural_heights_log2"])
        assert got == want


def write_reference_file() -> None:
    seg_size = MEMALLOC_SEG_SIZE
    st = rstate.State()
    st.memory.set_memory_range(0, rexamples.build_memalloc_guest(
        *MEMALLOC_ARGS))
    t0 = time.perf_counter()
    total, segs, _ = rutils.split_prog_into_segs(st, seg_size=seg_size)
    split_s = time.perf_counter() - t0
    all_stark = rall.make_all_stark(rall.SPONGE_SUBSET)
    records, witness_s = [], []
    for seg in segs:
        t0 = time.perf_counter()
        ts = rgen.generate_segment_traces(seg, sponge=True)
        witness_s.append(round(time.perf_counter() - t0, 1))
        traces = rhost.segment_traces(seg, all_stark)
        heights = [int(tr[0].shape[-1]).bit_length() - 1 for tr in traces]
        records.append(segment_record(seg, ts, heights))
        print(f"segment {seg.segment_id}: {seg.step} steps, heights 2^"
              f"{heights}, {len(ts.memory_ops)} memory ops", flush=True)
    record = {
        "guest": f"runtime.examples.build_memalloc_guest{MEMALLOC_ARGS}",
        "loaded_at": 0, "seg_size": seg_size,
        "subset": [t.name for t in rall.SPONGE_SUBSET],
        "total_steps": total, "num_segments": len(segs),
        "reference_split_seconds": round(split_s, 1),
        "reference_witness_seconds": witness_s,
        "reference_machine": f"{os.cpu_count()}-core CPU, zkm_tpu's "
                             "pure-Python emulator, JAX's CPU backend",
        "segments": records,
    }
    with open(MEMALLOC_RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record)[:2000], flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference_file()
