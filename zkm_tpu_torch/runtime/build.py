"""Guest build wrapper: the `zkm-build` crate analog (reference
build/src/lib.rs:10-13 wraps `cargo build` for the `mips-zkm-zkvm-elf`
target; build/src/command/ configures rustflags/docker).

Copy of zkm_tpu/runtime/build.py.

This image ships no Rust toolchain and no MIPS cross-compiler (see
docs/guest_toolchain.md for the full toolchain story), so this wrapper:

  1. builds with the reference toolchain when one is available
     (`cargo +zkm build --target mips-zkm-zkvm-elf`), matching zkm-build's
     invocation and env defaults;
  2. otherwise raises a BuildToolchainError carrying the exact install /
     invocation instructions — the same actionable-error pattern the
     reference uses for missing recursion circuits
     (fixed_recursive_verifier.rs:786-795).

Guests authored against the in-repo assembler SDK (runtime/asm.py,
runtime/guest.py, runtime/examples.py) need no toolchain at all, and
reference-built ELFs are consumed directly by the emulator
(`emulator.utils.load_elf_with_patch`).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional

MIPS_TARGET = "mips-zkm-zkvm-elf"   # build/src/lib.rs:10


class BuildToolchainError(RuntimeError):
    pass


@dataclass
class BuildArgs:
    """Mirrors zkm-build's clap BuildArgs (build/src/lib.rs:22-57)."""
    path: str
    features: List[str] = field(default_factory=list)
    release: bool = True
    elf_name: Optional[str] = None


def find_cargo() -> Optional[str]:
    return shutil.which("cargo")


def build_program(args: BuildArgs) -> str:
    """Build a Rust guest crate into a MIPS zkVM ELF; returns the ELF
    path.  Raises BuildToolchainError when no toolchain exists."""
    cargo = find_cargo()
    if cargo is None:
        raise BuildToolchainError(
            "no `cargo` in PATH: building compiled guests needs the "
            "reference MIPS toolchain.  Install rustup + the zkm "
            "toolchain (rustup toolchain link zkm <toolchain dir>), then "
            f"`cargo +zkm build --release --target {MIPS_TARGET}` in "
            f"{args.path}.  Prebuilt ELFs load directly via "
            "zkm_tpu_torch.emulator.utils.load_elf_with_patch; "
            "assembler-SDK guests (zkm_tpu_torch.runtime) need no "
            "toolchain.")
    cmd = [cargo, "build", "--target", MIPS_TARGET]
    if args.release:
        cmd.append("--release")
    for f in args.features:
        cmd += ["--features", f]
    env = dict(os.environ)
    # zkm-build's rustflags (build/src/command/utils.rs): no unwinding,
    # static relocation model, 4 KiB page-aligned sections.
    env.setdefault("RUSTFLAGS",
                   "-C target-cpu=mips32 -C relocation-model=static "
                   "-C panic=abort")
    proc = subprocess.run(cmd, cwd=args.path, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildToolchainError(
            f"cargo build failed (rc={proc.returncode}):\n{proc.stderr}")
    profile = "release" if args.release else "debug"
    out_dir = os.path.join(args.path, "target", MIPS_TARGET, profile)
    if args.elf_name:
        return os.path.join(out_dir, args.elf_name)
    elfs = [f for f in os.listdir(out_dir)
            if os.path.isfile(os.path.join(out_dir, f))
            and not f.endswith((".d", ".rlib"))]
    if len(elfs) != 1:
        raise BuildToolchainError(
            f"expected one ELF in {out_dir}, found {elfs}; pass elf_name")
    return os.path.join(out_dir, elfs[0])
