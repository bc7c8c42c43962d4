"""zkm_tpu_torch's env-var CLI (`python -m zkm_tpu_torch.cli`) and
`runtime/build.py` against zkm_tpu's, on the CPU (DEVICE=cpu).

`split-seg` must write segment files byte-equal to `zkm_tpu.cli
split-seg`'s for the same ELF.  The in-repo guests are raw programs, so
the ELF is `runtime.examples.guest_elf` of one.  The record the card is
held to (`chip_smoke.py` phase 9a) is made again with

    python tests/test_torch_cli.py --write

which runs zkm_tpu's `split-seg` on fib(40)'s ELF at SEG_SIZE=1800 and
writes `zkm_tpu_torch/data/cli_reference.json` (seconds).  A proof on the
CPU takes minutes and a wrap ~2 min of setup, so `prove-seg` and `wrap`
end to end are the slow tests.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

from zkm_tpu import cli as rcli  # noqa: E402
from zkm_tpu_torch.runtime import examples  # noqa: E402
from zkm_tpu_torch.witness.trace_set import DATA  # noqa: E402

RECORD = os.path.join(DATA, "cli_reference.json")
FIB_N, SEG_SIZE = 40, 1800


def fib_elf(tmp) -> str:
    path = os.path.join(str(tmp), "fib.elf")
    with open(path, "wb") as f:
        f.write(examples.guest_elf(examples.build_fib_guest(FIB_N)))
    return path


def run_cli(cmd: str, env: dict, check: bool = True, timeout: int = 600):
    """`python -m zkm_tpu_torch.cli cmd` with `env` added."""
    proc = subprocess.run([sys.executable, "-m", "zkm_tpu_torch.cli", cmd],
                          cwd=ROOT, env={**os.environ, **env},
                          capture_output=True, text=True, timeout=timeout)
    if check and proc.returncode != 0:
        raise AssertionError(f"cli {cmd} failed:\n{proc.stderr}")
    return proc


def reference_split_seg(monkeypatch, elf: str, out: str, seg_size: int,
                        args: str = "") -> None:
    for k, v in (("ELF_PATH", elf), ("SEG_OUTPUT", out),
                 ("SEG_SIZE", str(seg_size)), ("ARGS", args)):
        monkeypatch.setenv(k, v)
    rcli.cmd_split_seg()


def files(out: str) -> dict:
    """{segment file name: its sha256} of a SEG_OUTPUT directory."""
    got = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            got[name] = hashlib.sha256(f.read()).hexdigest()
    return got


def segments_of(out: str) -> list:
    from zkm_tpu_torch.emulator.state import Segment
    segs = []
    for name in sorted(os.listdir(out), key=int):
        with open(os.path.join(out, name)) as f:
            s = Segment.from_json(f.read())
        segs.append({"step": s.step, "pre_image_id": s.pre_image_id.hex(),
                     "image_id": s.image_id.hex()})
    return segs


@pytest.mark.parametrize("seg_size,args", [(SEG_SIZE, ""), (1 << 16, "x yz")])
def test_split_seg_files_equal_reference(tmp_path, monkeypatch, seg_size,
                                         args):
    elf = fib_elf(tmp_path)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    proc = run_cli("split-seg", {"ELF_PATH": elf, "SEG_OUTPUT": ours,
                                 "SEG_SIZE": str(seg_size), "ARGS": args,
                                 "DEVICE": "cpu"})
    reference_split_seg(monkeypatch, elf, ref, seg_size, args)
    assert files(ours) == files(ref)
    assert len(files(ours)) == (2 if seg_size == SEG_SIZE else 1)
    assert proc.stdout.startswith(f"split done: 335 steps into "
                                  f"{len(files(ours))} segments at {ours}")
    assert "launches: K1 0, K2 0" in proc.stdout     # the CPU runs no kernel


def test_split_seg_matches_record(tmp_path):
    with open(RECORD) as f:
        record = json.load(f)
    out = str(tmp_path / "segs")
    run_cli("split-seg", {"ELF_PATH": fib_elf(tmp_path), "SEG_OUTPUT": out,
                          "SEG_SIZE": str(record["seg_size"]),
                          "DEVICE": "cpu"})
    assert files(out) == record["files_sha256"]
    assert segments_of(out) == record["segments"]


@pytest.mark.parametrize("cmd", ["split-seg", "wrap"])
def test_cli_without_card_raises(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = run_cli(cmd, {"ELF_PATH": fib_elf(tmp_path),
                         "SEG_OUTPUT": str(tmp_path / "segs"),
                         "PROOF_JSON": str(tmp_path / "none.json"),
                         "OUTPUT_DIR": str(tmp_path / "out"),
                         "DEVICE": ""}, check=False)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "segs")


def test_cli_usage_and_missing_variables(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "zkm_tpu_torch.cli"],
                          cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and "split-seg" in proc.stderr
    proc = run_cli("no-such-command", {}, check=False)
    assert "unknown command no-such-command" in proc.stderr
    proc = run_cli("prove-seg", {"DEVICE": "cpu"}, check=False)
    assert proc.returncode != 0
    assert "missing required env var SEG_FILE" in proc.stderr


def test_build_wrapper_raises_without_toolchain():
    from zkm_tpu_torch.runtime.build import (BuildArgs, BuildToolchainError,
                                             build_program, find_cargo)
    if find_cargo() is not None:
        pytest.skip("cargo present; error path not reachable")
    with pytest.raises(BuildToolchainError, match="mips-zkm-zkvm-elf"):
        build_program(BuildArgs(path="/nonexistent-guest"))


@pytest.mark.slow
def test_cli_prove_seg_on_cpu(tmp_path):
    out = str(tmp_path / "segs")
    run_cli("split-seg", {"ELF_PATH": fib_elf(tmp_path), "SEG_OUTPUT": out,
                          "SEG_SIZE": str(SEG_SIZE), "DEVICE": "cpu"})
    proc = run_cli("prove-seg", {"SEG_FILE": os.path.join(out, "1"),
                                 "DEVICE": "cpu"}, timeout=3600)
    image_id = segments_of(out)[1]["image_id"]
    assert f"segment 1 proved and verified; image id {image_id}" \
        in proc.stdout


@pytest.mark.slow
def test_cli_wrap_end_to_end(tmp_path):
    """A seeded key in a ZKM_CIRCUIT_CACHE directory, then `cli wrap` of
    zkm_tpu's toy root: the proof verifies under that key, a changed
    public input does not, and verifier.sol is that key's."""
    from tests.test_torch_snark import read_wrapped_json, toy_root_document
    from zkm_tpu_torch.snark import contract, groth16 as g16, mimc, wrap
    cache_dir, out = str(tmp_path / "cache"), str(tmp_path / "out")
    pk = wrap.groth16_setup(seed=b"cli wrap test")
    wrap.save_proving_key(pk, cache_dir)
    doc_path = str(tmp_path / "root.json")
    with open(doc_path, "w") as f:
        json.dump(toy_root_document(), f)
    run_cli("wrap", {"PROOF_JSON": doc_path, "OUTPUT_DIR": out,
                     "ZKM_CIRCUIT_CACHE": cache_dir, "DEVICE": "cpu"})
    with open(os.path.join(out, "verifier.sol")) as f:
        assert f.read() == contract.emit_verifier_sol(pk.vk)
    with open(os.path.join(out, "snark_proof_with_public_inputs.json")) as f:
        proof, publics = read_wrapped_json(f.read())
    assert publics[0] == mimc.hash_elements(
        wrap.claim_limbs(toy_root_document()))
    assert g16.verify(pk.vk, publics, proof)
    assert not g16.verify(pk.vk, [publics[0] + 1] + publics[1:], proof)


def write_reference_file() -> None:
    import tempfile

    import _pytest.monkeypatch
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "segs")
        mp = _pytest.monkeypatch.MonkeyPatch()
        reference_split_seg(mp, fib_elf(tmp), out, SEG_SIZE)
        mp.undo()
        record = {
            "elf": f"runtime.examples.guest_elf(build_fib_guest({FIB_N}))",
            "command": "zkm_tpu.cli split-seg", "seg_size": SEG_SIZE,
            "files_sha256": files(out), "segments": segments_of(out)}
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    write_reference_file()
