"""zkm_tpu_torch's native interpreter core (`emulator/native.py`,
`csrc/mips_core.cpp`) against zkm_tpu's native path, on the CPU.

Native segments end where the core's chunks end, so they are held against
zkm_tpu's *native* split, never against the Python split (whose
boundaries differ); the final state is held against the Python
interpreter.  Equality is exact.  The frozen record is made again with

    python tests/test_torch_native.py --write

which splits each case with zkm_tpu's native core (seconds) and writes
`zkm_tpu_torch/data/native_segments_reference.json`.
"""

import hashlib
import json
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

from zkm_tpu.emulator import state as rstate  # noqa: E402
from zkm_tpu.emulator import utils as rutils  # noqa: E402
from zkm_tpu_torch.emulator import native, state, utils  # noqa: E402
from zkm_tpu_torch.runtime import examples  # noqa: E402
from zkm_tpu_torch.witness.trace_set import DATA  # noqa: E402

CPU = "cpu"
RECORD = os.path.join(DATA, "native_segments_reference.json")

# name -> (guest, seg_size, loaded as an ELF)
CASES = {
    "memalloc": ("build_memalloc_guest(64, 64)", 1 << 16, False),
    "memalloc_2^14": ("build_memalloc_guest(64, 64)", 1 << 14, False),
    "fib_elf": ("build_fib_guest(40)", 1800, True),
    "hash": ("build_hash_guest()", 1 << 16, False),
}


def program(guest: str):
    """(program bytes, hint inputs) of a `runtime.examples` guest call."""
    name, args = guest.split("(")
    args = [int(a) for a in args.rstrip(")").split(",") if a.strip()]
    inputs = (examples.hash_guest_input(),) if name == "build_hash_guest" \
        else ()
    return getattr(examples, name)(*args), inputs


def load(state_mod, utils_mod, case: str, tmp: str, **kw):
    """A state of `case` in either package (kw: its device/native)."""
    guest, _, as_elf = CASES[case]
    prog, inputs = program(guest)
    if as_elf:
        path = os.path.join(tmp, f"{case}.elf")
        with open(path, "wb") as f:
            f.write(examples.guest_elf(prog))
        st = utils_mod.load_elf_with_patch(path, [], **kw)
    else:
        st = state_mod.State(**kw)
        st.memory.set_memory_range(0, prog)
    for raw in inputs:
        st.add_input_stream_bytes(raw)
    return st


def split_record(utils_mod, st, seg_size: int) -> dict:
    total, segs, final = utils_mod.split_prog_into_segs(st, seg_size=seg_size)
    return {
        "total_steps": total, "exit_code": final.exit_code,
        "segments": [{"step": s.step, "pc": s.pc, "end_pc": s.end_pc,
                      "pre_image_id": s.pre_image_id.hex(),
                      "image_id": s.image_id.hex(),
                      "file_sha256": hashlib.sha256(
                          s.to_json().encode()).hexdigest()}
                     for s in segs]}


def port_native_split(case: str, tmp: str) -> dict:
    st = load(state, utils, case, tmp, device=CPU, native=True)
    assert hasattr(st.memory, "run")
    return split_record(utils, st, CASES[case][1])


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def test_core_builds_with_gpp():
    lib = native.load_core()
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libmips_core_")
    assert lib is native.load_core()
    assert native.SOURCE.endswith(os.path.join("csrc", "mips_core.cpp"))


@pytest.mark.parametrize("case", list(CASES))
def test_native_split_matches_reference_record(case, record, tmp_path):
    got = port_native_split(case, str(tmp_path))
    want = record["cases"][case]
    assert {k: want[k] for k in got} == got
    assert (want["guest"], want["seg_size"], want["elf"]) == CASES[case]


@pytest.mark.parametrize("case", ["fib_elf", "memalloc_2^14"])
def test_native_split_matches_reference_live(case, tmp_path):
    """The same against zkm_tpu's native path run here (its core built from
    its own source)."""
    ref = load(rstate, rutils, case, str(tmp_path), native=True)
    assert hasattr(ref.memory, "run"), "zkm_tpu's native core is missing"
    want = split_record(rutils, ref, CASES[case][1])
    assert port_native_split(case, str(tmp_path)) == want
    assert len(want["segments"]) > 1 or case == "fib_elf"


def test_native_segments_differ_from_python_but_end_alike(tmp_path):
    """The native split of fib's ELF ends where the Python split ends, at
    other boundaries (zkm_tpu behaves the same, per the record)."""
    nat = port_native_split("fib_elf", str(tmp_path))
    py = split_record(utils, load(state, utils, "fib_elf", str(tmp_path),
                                  device=CPU), 1800)
    assert [s["step"] for s in py["segments"]] != \
        [s["step"] for s in nat["segments"]]
    assert py["total_steps"] == nat["total_steps"]
    assert py["segments"][0]["pre_image_id"] == \
        nat["segments"][0]["pre_image_id"]
    assert py["segments"][-1]["image_id"] == nat["segments"][-1]["image_id"]


@pytest.mark.parametrize("case", ["hash", "memalloc", "fib_elf"])
def test_native_final_state_matches_python(case, tmp_path):
    """Run to the end on both interpreters (the hash guest's keccak and SHA
    syscalls, memalloc's mmap and every commit go back to Python)."""
    out = []
    for nat in (False, True):
        st = load(state, utils, case, str(tmp_path), device=CPU, native=nat)
        ist = state.InstrumentedState(st)
        steps = 0
        while not ist.state.exited and steps < 200_000:
            steps += ist.run_fast(10_000)
        s = ist.state
        out.append((steps, s.exited, s.exit_code, tuple(s.registers),
                    (s.pc, s.next_pc, s.hi, s.lo, s.heap, s.brk),
                    bytes(ist.stdout_buf), bytes(s.public_values_stream)))
    assert out[0][1] and out[0] == out[1]


def test_native_fault_replays_in_python_and_raises():
    st = state.State(CPU, native=True)
    st.memory.set_memory_range(0, (0xFC000000).to_bytes(4, "big"))
    with pytest.raises(ValueError, match="invalid instruction"):
        state.InstrumentedState(st).run_fast(10)


def test_native_without_compiler_raises(monkeypatch, tmp_path):
    """No fallback: native=True with no core raises, where zkm_tpu's
    load_core returns None and carries on in Python."""
    monkeypatch.setattr(native, "_core_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(native.NativeCoreError, match="no C..? compiler"):
        state.State(CPU, native=True)
    elf = tmp_path / "fib.elf"
    elf.write_bytes(examples.guest_elf(examples.build_fib_guest(3)))
    with pytest.raises(native.NativeCoreError):
        utils.load_elf_with_patch(str(elf), [], CPU, native=True)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(native.NativeCoreError, match="failed"):
        native.load_core()


def test_native_state_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st = state.State(native=True)
        st.memory.set_memory_range(0, examples.build_fib_guest(3))
        utils.split_prog_into_segs(st, seg_size=1 << 16)


def write_reference_file() -> None:
    import tempfile
    cases = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case, (guest, seg_size, as_elf) in CASES.items():
            t0 = time.perf_counter()
            st = load(rstate, rutils, case, tmp, native=True)
            assert hasattr(st.memory, "run"), "no zkm_tpu native core"
            got = split_record(rutils, st, seg_size)
            cases[case] = {"guest": guest, "seg_size": seg_size,
                           "elf": as_elf, **got,
                           "reference_seconds": round(
                               time.perf_counter() - t0, 1)}
            print(case, json.dumps(cases[case])[:300], flush=True)
    with open(RECORD, "w") as f:
        json.dump({"reference_machine": f"{os.cpu_count()}-core CPU, "
                   "zkm_tpu's native core, JAX's CPU backend",
                   "cases": cases}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference_file()
