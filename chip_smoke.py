#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits nonzero):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
     print the card's name and power limit;
  2. each kernel against its plain PyTorch version on the card, bit for
     bit (tolerance 0: everything is an integer mod p), with times; K2 also
     at 816 shapes (`check_k2_shapes`);
  3. segment-scale trace commits (rate 2, cap 4) of random traces shaped
     like a hello segment's tables, and one cap checked against the CPU;
  4. a 2^16-row Logic proof with its self-CTL under standard_fast_config,
     verified by the port's verifier; the same statement at 2^10 rows
     against the CPU digest; the frozen golden Logic proof;
  5. whole SPONGE_SUBSET segment proofs of the toy segment (the 11
     instructions of TOY_PROGRAM): (a) from program bytes through the
     port's emulator (split_prog_into_segs) and host.prove_segment at
     natural heights: the fresh witness must equal the frozen one
     (zkm_tpu_torch/data) field for field, the public values and the
     flattened sha256 zkm_tpu's; the port's verifier accepts the proof
     and rejects a tampered copy; (b) the frozen witness at a hello
     segment's heights (SEGMENT_TABLES floors), one proof, verified;
  6. the main path: the memalloc guest (runtime.examples.
     build_memalloc_guest(64, 64)) assembled, split at 2^16 cycles and
     proved by host.prove_segment at its natural heights, a first and a
     warm run, each verified, with per-step times (emulate, witness,
     trace_build and the prover's steps), K1 and K2 launches per step and
     peak device memory; the segment and its witness must match zkm_tpu's
     record (zkm_tpu_torch/data/memalloc_segment_reference.json); with
     --profile also a warm host.prove_segment of that segment under
     torch.profiler: device-busy share and device time per kernel name;
  7. all 12 tables and 15 CTLs (FULL_SUBSET): (a) the full guest
     (runtime.examples.build_full_guest, every table family) split at 2^20
     and proved by host.prove_segment at natural heights: its witness's
     field digests, public values, heights and flattened sha256 must equal
     zkm_tpu's record (zkm_tpu_torch/data/full_segment_reference.json);
     the port's verifier accepts the proof and rejects a tampered copy,
     and a proof with debug=True (each table's constraints checked on its
     rows first) has the same digest; (b) the slice's main path: the
     hash-heavy guest (runtime.examples.build_hash_guest: 12 keccak256s of
     a 4000-byte input, 128 chained SHA-256 blocks) split at 2^16 cycles
     into one segment whose Keccak and ShaCompress tables hold 2^14 rows,
     proved end to end, a first and a warm run, each verified, with
     per-step times, K1/K2 launches and peak device memory per step and
     each table's quotient buffer; the segment and its witness must match
     zkm_tpu's record (zkm_tpu_torch/data/hash_segment_reference.json);
     with --profile also a warm host.prove_segment of it under
     torch.profiler;
  8. receipts, composition and recursion: (a) tests/test_recursion_
     aggregate.py's statement (two Logic proofs, roots 0->1->2, under its
     _rconfig) proved, shrunk through one build_shrink_circuit and
     aggregated by AggregationTree on the card: the inner, shrink and root
     proofs' flattened sha256, the shrink DAG's counts and both program
     caps must equal zkm_tpu's record (zkm_tpu_torch/data/
     recursion_toy_reference.json); a tampered claim is rejected; and the
     composition guest's composite receipt (SYS_VERIFY) verifies and is
     rejected with its assumption unresolved; (b) the slice's main path
     (scripts/recursion_stages.py's workload): fib(40) split at seg_size
     1800 into 2 segments, both proved under Cpu/Logic/Memory and
     test_config, the shrink circuit recorded from segment 0, both proofs
     shrunk, and the aggregation root proved and verified with the chained
     claim (a tampered claim rejected), with per-step times, K1/K2
     launches and peak device memory per step, the heights of every
     table and the DAG counts; segments, inner digests, the shrink DAG's
     counts, program cap and heights must equal zkm_tpu's record
     (zkm_tpu_torch/data/recursion_fib_reference.json); with --profile
     also the root's prove under torch.profiler;
  9. from a program to an on-chain proof: (a) the env-var CLI
     (`python -m zkm_tpu_torch.cli`), each command a process on the card:
     split-seg of fib(40)'s ELF (runtime.examples.guest_elf) at SEG_SIZE
     1800, whose segment files must be byte-equal to zkm_tpu.cli's
     (zkm_tpu_torch/data/cli_reference.json), then prove-seg of segment 0
     and prove-elf of the ELF, each receipt verified, each command timed
     with the K1/K2 launches it reports; (b) the native C++ core: the
     memalloc guest split at 2^16 cycles with State(native=True), against
     zkm_tpu's native record (zkm_tpu_torch/data/native_segments_
     reference.json) and, for its last image id, phase 6's record; the
     record's other cases (memalloc at 2^14 in 5 segments, fib's ELF
     through load_elf_with_patch(native=True), the hash guest); one native
     segment proved and verified; emulate seconds native against Python;
     (c) the STARK -> Groth16/BN254 wrap on the host: one seeded setup of
     the wrap circuit, the seeded wrap of the record's fixed document bit
     for bit against zkm_tpu's (zkm_tpu_torch/data/wrap_reference.json:
     verifier.sol's hash, proof and public inputs), then phase 8b's root
     exported (export.export_proof with its program cap) and wrapped by
     `cli wrap` (its key read from ZKM_CIRCUIT_CACHE): it verifies, a
     changed public input is rejected, public_inputs[0] is the claim
     limbs' MiMC digest and verifier.sol has one ecMulAdd line per public
     input;
 10. proving over several ranks (zkm_tpu_torch/parallel/: processes
     spawned by parallel.launch, collectives over gloo, every rank on
     cuda:0 because NCCL refuses two ranks on one card, as two ranks
     calling make_mesh with its default backend show first; with two
     cards also 10b over NCCL, with four also 10a, one card per rank),
     the cached device memory released first: (a) the three sharded steps of parallel/sharding.py at
     (dp, tp) = (2, 2) on 4 ranks: commits (rate 2, cap 4) of two
     Cpu-shaped (260, 2^16) and two Memory-shaped (13, 2^19) traces and
     two 2^16-row Logic traces, the Logic quotient and its folds at
     arity_bits 2 and 4, each rank's blocks bit-equal (sha256) to the
     same steps on one card; (b) phase 6's memalloc segment through
     host.prove_segment(mesh=) at tp = 2: both ranks' proofs must have
     phase 6's flattened sha256, and the proof verifies; (c) 8b's fib(40)
     segments through host.prove_segments at (dp, tp) = (2, 1), one
     segment a dp group: each rank's gathered receipts have the record's
     inner digests and chain.  Per rank: per-step ms, K1/K2 launches,
     peak memory and the bytes and ms of its collectives.
The line before the last is {"kernels": [...]}, with the launches of
phases 8b, 9 and 10 added up (9a's from what its commands print, 10's
from every rank); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "golden_vectors.json")
P = (1 << 64) - (1 << 32) + 1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT32_LANES_PER_SM = 64          # Hopper SM: 64 INT32 lanes per clock

# Hello-segment SPONGE_SUBSET shapes: (table, log2 rows, columns).  The two
# Poseidon heights are assumed.
SEGMENT_TABLES = [("Cpu", 16, 260), ("Memory", 19, 13), ("Arithmetic", 16, 54),
                  ("Poseidon", 16, 262), ("PoseidonSponge", 16, 112),
                  ("Logic", 16, 69)]

# K2 against its plain version: every log_n up to 12 (one pass, and each
# pass boundary of ntt.plan), the main path's sizes and the largest two-
# and three-pass sizes (22, 23), at these row counts, with n_in = N >> rate
# for rate 0, 1, 2, in four modes: (inverse, scaled, factor != 1).  At
# log_n K2_MANY_ROWS_LOG_N also K2_MANY_ROWS rows, more than the grid's
# 65535, which the kernels' row loops cover.
K2_LOG_NS = tuple(range(1, 13)) + (16, 17, 18, 19, 21, 22, 23)
K2_ROWS = (1, 2, 13, 69, 260)
K2_MANY_ROWS, K2_MANY_ROWS_LOG_N = 70_000, 4
K2_MODES = ((False, False, False), (True, False, True), (False, True, False),
            (True, True, True))
K2_MAX_VALUES = 1 << 26          # rows x N cap for the plain version's memory

# bench._toy_segment()'s program; the frozen toy witness is its segment's
TOY_PROGRAM = (0x24080005, 0x2409000A, 0x01095020, 0x3508BEEF, 0x01096824,
               0x01097025, 0xAE2A0000, 0x8E2B0000, 0x24021096, 0x24040000,
               0x0000000C)
MEMALLOC_ARGS, MEMALLOC_SEG_SIZE = (64, 64), 1 << 16
FULL_SEG_SIZE, HASH_SEG_SIZE = 1 << 20, 1 << 16
FIB_N, FIB_SEG_SIZE = 40, 1800   # scripts/recursion_stages.py's workload


def log(msg: str) -> None:
    print(msg, flush=True)


class LaunchTimer:
    """Per-step wall seconds (utils.timing.StepTimer) and K1/K2 launches,
    for the host functions' `timer` argument; with step_peaks also each
    step's peak device memory (the peak statistics are reset as each step
    starts, so a caller reads the run's peak as the largest of them)."""

    def __init__(self, dev, step_peaks: bool = False, comm=None):
        from zkm_tpu_torch.utils.timing import StepTimer
        self.timer = StepTimer(dev)
        self.seconds = self.timer.seconds
        self.launches = {}
        self.step_peaks = step_peaks
        self.peak_gib = {}
        self.comm = comm            # a parallel.comm.Comm: its calls per step
        self.moved = {}

    @contextlib.contextmanager
    def step(self, name: str):
        import torch
        from zkm_tpu_torch.field import ntt
        from zkm_tpu_torch.hash import poseidon as ps
        k1, k2 = ps.LAUNCHES, ntt.LAUNCHES
        c0 = self.comm.stats() if self.comm is not None else None
        if self.step_peaks:
            torch.cuda.reset_peak_memory_stats()
        with self.timer.step(name):
            yield
        got = self.launches.setdefault(name, [0, 0])
        got[0] += ps.LAUNCHES - k1
        got[1] += ntt.LAUNCHES - k2
        if c0 is not None:
            moved = self.moved.setdefault(name, [0, 0, 0.0])
            for i, (a, b) in enumerate(zip(c0, self.comm.stats())):
                moved[i] += b - a
        if self.step_peaks:
            self.peak_gib[name] = max(self.peak_gib.get(name, 0.0),
                                      torch.cuda.max_memory_allocated() / 2**30)

    def report(self) -> str:
        return ", ".join(
            f"{k} {v * 1e3:.1f} ms (K1 {self.launches[k][0]}, K2 "
            f"{self.launches[k][1]}"
            + (f", peak {self.peak_gib[k]:.2f} GiB" if k in self.peak_gib
               else "")
            + (f", collectives {self.moved[k][0]}: "
               f"{self.moved[k][1] / 2**20:.1f} MiB in "
               f"{self.moved[k][2] * 1e3:.1f} ms" if k in self.moved else "")
            + ")" for k, v in self.seconds.items())


def reset_launches() -> None:
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps
    ps.LAUNCHES = 0
    ntt.LAUNCHES = 0


def read_launches() -> dict:
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps
    return {"poseidon_permute": ps.LAUNCHES, "goldilocks_ntt": ntt.LAUNCHES}


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def random_field(rng, shape) -> np.ndarray:
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: np.ndarray, b: np.ndarray) -> float:
    bad = np.nonzero(a != b)
    if not bad[0].size:
        return 0.0
    return float(max(abs(int(x) - int(y)) for x, y in zip(a[bad], b[bad])))


def int32_ops_per_s() -> float:
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def phase_build() -> dict:
    from zkm_tpu_torch import native
    t0 = time.perf_counter()
    per_lib = native.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(per_lib)} "
        f"(per library: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                      sorted(per_lib.items())) + ")")
    log(nvidia_smi("name,power.limit"))
    return per_lib


def phase_kernels(rng, dev) -> dict:
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from zkm_tpu_torch.convert import from_u64, to_u64
    from zkm_tpu_torch.field import goldilocks as gl
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps

    rate = int32_ops_per_s()
    out = {}

    # K1 at the PoW grind's batch, plus the golden permutation vectors.
    b = 1 << 16
    states = from_u64(random_field(rng, (b, 12)), dev)
    got = to_u64(ps.permute(states))
    want = to_u64(ps._permute_plain(states))
    err = max_abs_err(got, want)
    with open(GOLDEN) as f:
        golden = json.load(f)["poseidon_permute"]
    gin = from_u64(np.array([[int(x) for x in c["input"]] for c in golden],
                            dtype=np.uint64), dev)
    gout = to_u64(ps.permute(gin))
    golden_ok = all([str(int(x)) for x in gout[i]] == c["output"]
                    for i, c in enumerate(golden))
    ms = cuda_ms(lambda: ps.permute(states), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: ps._permute_plain(states), reps=3)
    ops_bound = ps.ops_per_permutation() * b / rate * 1e3
    bytes_bound = 2 * 96 * b / HBM_BYTES_PER_S * 1e3
    out["poseidon_permute"] = dict(
        name="poseidon_permute", route="cuda",
        source="zkm_tpu_torch/csrc/poseidon.cu",
        replaces="zkm_tpu/ops/pallas_poseidon.py:104",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(ops_bound, bytes_bound),
        bound_by="operations" if ops_bound >= bytes_bound else "bytes",
        library_ms=None)
    log(f"[kernels] K1 poseidon B={b}: max_abs_err {err} golden "
        f"{'ok' if golden_ok else 'MISMATCH'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {out['poseidon_permute']['bound_ms']:.4f} ms "
        f"({ps.ops_per_permutation()} int32 ops/permutation at "
        f"{rate / 1e12:.2f} Tops/s, an estimate)")
    if err or not golden_ok:
        raise AssertionError("K1 disagrees with its plain version")

    # K2: intt -> lde at rate 2 on (69, 2^16), the Logic trace commit.
    c, log_n, rate_bits = 69, 16, 2
    n = 1 << log_n
    values = from_u64(random_field(rng, (c, n)), dev)
    n_inv = gl.host_inv(n)
    shift_pw = ntt.shift_powers(n, gl.GENERATOR, False, values.device)

    def kernel():
        return ntt.lde(ntt.intt(values), rate_bits)

    def plain():
        coeffs = ntt._transform_plain(values, log_n, True, None, n_inv)
        return ntt._transform_plain(coeffs, log_n + rate_bits, False,
                                    shift_pw, 1)
    got, want = to_u64(kernel()), to_u64(plain())
    err = max_abs_err(got, want)
    ms = cuda_ms(kernel, reps=10, warmup=2)
    plain_ms = cuda_ms(plain, reps=2)
    m = n << rate_bits
    # the butterflies the function needs: the lde's first rate_bits stages
    # only copy its zero padding, so of its log_n + rate_bits stages log_n
    # remain.  all_stages_bound counts those copies as butterflies too, as
    # the per-stage design had to.
    butterflies = c * (n // 2 * log_n + m // 2 * log_n)
    copies = c * m // 2 * rate_bits
    scale_muls = 2 * c * n
    ops_bound = (butterflies * 36 + scale_muls * 26) / rate * 1e3
    bytes_bound = 8 * c * (n + m) / HBM_BYTES_PER_S * 1e3
    all_stages_bound = ops_bound + copies * 36 / rate * 1e3
    out["goldilocks_ntt"] = dict(
        name="goldilocks_ntt", route="cuda",
        source="zkm_tpu_torch/csrc/ntt.cu",
        replaces="zkm_tpu/field/ntt.py:83",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(ops_bound, bytes_bound),
        bound_by="operations" if ops_bound >= bytes_bound else "bytes",
        library_ms=None)
    log(f"[kernels] K2 ntt intt->lde (69, 2^16) rate 2: max_abs_err {err}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.2f} ms, bound "
        f"{out['goldilocks_ntt']['bound_ms']:.4f} ms ({all_stages_bound:.4f} "
        f"ms counting the lde's {rate_bits} stages that copy padding); "
        f"passes {len(ntt.plan(log_n))} + "
        f"{len(ntt.plan(log_n + rate_bits))}")
    if err:
        raise AssertionError("K2 disagrees with its plain version")
    check_k2_shapes(dev)
    return out


def check_k2_shapes(dev, seed: int = 1) -> None:
    """K2 bit-equal to `_transform_plain` at every K2_LOG_NS x K2_ROWS x
    rate x K2_MODES case; at the large sizes the rows cycle through those
    that fit K2_MAX_VALUES.  Inputs are slices of one random pool, from a
    generator of its own so that the later phases' inputs do not depend
    on these checks."""
    import torch
    from zkm_tpu_torch.convert import from_u64
    from zkm_tpu_torch.field import goldilocks as gl
    from zkm_tpu_torch.field import ntt

    rng = np.random.default_rng(seed)
    pool = from_u64(random_field(rng, K2_MAX_VALUES), dev)
    cases = bad = 0
    t0 = time.perf_counter()
    for log_n in K2_LOG_NS:
        n = 1 << log_n
        fits = [r for r in K2_ROWS if r * n <= K2_MAX_VALUES]
        for rate in (0, 1, 2):
            n_in = max(1, n >> rate)
            for m, (inverse, scaled, scaled_by_factor) in enumerate(K2_MODES):
                if log_n > 12:
                    rows_list = [fits[(log_n + 3 * rate + m) % len(fits)]]
                elif log_n == K2_MANY_ROWS_LOG_N:
                    rows_list = fits + [K2_MANY_ROWS]
                else:
                    rows_list = fits
                for rows in rows_list:
                    at = int(rng.integers(0, K2_MAX_VALUES - rows * n_in + 1))
                    x = pool[at:at + rows * n_in].view(rows, n_in)
                    scale = pool[:n_in].flip(0) if scaled else None
                    factor = (gl.host_inv(n) if inverse else 12345) \
                        if scaled_by_factor else 1
                    got = ntt.transform(x, log_n, inverse, scale, factor)
                    want = ntt._transform_plain(x, log_n, inverse, scale,
                                                factor)
                    cases += 1
                    if not torch.equal(got, want):
                        bad += 1
                        log(f"[kernels] K2 MISMATCH log_n {log_n} rows {rows} "
                            f"n_in {n_in} inverse {inverse} scaled {scaled} "
                            f"factor {factor}")
    torch.cuda.synchronize()
    log(f"[kernels] K2 against its plain version at {cases} shapes (log_n "
        f"{K2_LOG_NS[0]}-{K2_LOG_NS[11]}, {', '.join(map(str, K2_LOG_NS[12:]))}; "
        f"rows {', '.join(map(str, K2_ROWS))}, and {K2_MANY_ROWS} at log_n "
        f"{K2_MANY_ROWS_LOG_N}; rate 0-2; 4 modes), tolerance "
        f"0: {cases - bad} bit-equal, {bad} differ "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version at {bad} "
                             f"shapes")


def phase_commits(rng, dev) -> None:
    import torch
    from zkm_tpu_torch.commit.polynomial_batch import PolynomialBatch
    from zkm_tpu_torch.convert import from_u64
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps

    for name, log_n, cols in SEGMENT_TABLES:
        values = from_u64(random_field(rng, (cols, 1 << log_n)), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1, k2 = ps.LAUNCHES, ntt.LAUNCHES
        t0 = time.perf_counter()
        batch = PolynomialBatch.from_values(values, 2, 4, device=dev)
        cap = batch.cap_u64()
        ms = (time.perf_counter() - t0) * 1e3
        assert cap.shape == (16, 4) and (cap < P).all()
        log(f"[commit] {name:14s} ({cols}, 2^{log_n}): {ms:9.2f} ms, "
            f"K1 launches {ps.LAUNCHES - k1}, K2 launches "
            f"{ntt.LAUNCHES - k2}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del batch, values
    small = random_field(rng, (69, 1 << 12))
    gpu = PolynomialBatch.from_values(from_u64(small), 2, 4, device=dev)
    cpu = PolynomialBatch.from_values(from_u64(small), 2, 4, device="cpu")
    same = np.array_equal(gpu.cap_u64(), cpu.cap_u64())
    log(f"[commit] (69, 2^12) cap on the card == CPU path: {same}")
    if not same:
        raise AssertionError("card and CPU commitments differ")


def _logic_statement(rng, log_rows: int):
    from zkm_tpu_torch.stark.cross_table_lookup import (CrossTableLookup,
                                                        TableWithColumns)
    from zkm_tpu_torch.stark.proof import MemRoots, PublicValues
    from zkm_tpu_torch.tables import logic
    k = 1 << log_rows
    ops = np.stack([rng.integers(0, 4, k), rng.integers(0, 1 << 32, k),
                    rng.integers(0, 1 << 32, k)], axis=1)
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    ctls = [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]
    pv = PublicValues(MemRoots.from_image_id(bytes(range(32))),
                      MemRoots.from_image_id(bytes(range(32, 64))), bytes(32))
    return logic.generate_rows(ops, min_rows=64), ctls, pv


def _prove(rows, ctls, pv, config, device, timer=None):
    from zkm_tpu_torch.convert import traces_from_rows
    from zkm_tpu_torch.stark.prover import prove_with_traces
    from zkm_tpu_torch.tables import logic
    return prove_with_traces([logic.LogicStark()], config,
                             traces_from_rows([rows], device), ctls, pv,
                             device=device, timer=timer)


def phase_proof(rng, dev) -> None:
    import torch
    from zkm_tpu_torch.stark.config import StarkConfig
    from zkm_tpu_torch.stark.cross_table_lookup import (CrossTableLookup,
                                                        TableWithColumns)
    from zkm_tpu_torch.stark.proof import (MemRoots, PublicValues,
                                           flat_sha256, flatten_proof)
    from zkm_tpu_torch.stark.verifier import verify_proof
    from zkm_tpu_torch.tables import logic
    from zkm_tpu_torch.utils.timing import StepTimer

    config = StarkConfig.standard_fast_config()
    rows, ctls, pv = _logic_statement(rng, 16)

    # The Logic path's launches (the main path's are phase 6's): counts
    # set to 0 just before, read just after.
    reset_launches()
    timer = StepTimer(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = _prove(rows, ctls, pv, config, dev, timer)
    total = time.perf_counter() - t0
    launches = read_launches()
    steps = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.seconds.items())
    log(f"[proof] Logic 2^16 standard_fast_config on the card: {total:.3f} s "
        f"({steps}); launches {launches}")
    digest = flat_sha256(flatten_proof(proof))
    t0 = time.perf_counter()
    verify_proof([logic.LogicStark()], proof, ctls, config)
    log(f"[proof] verified by the port's verifier in "
        f"{time.perf_counter() - t0:.1f} s; flattened sha256 {digest}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    rows, ctls, pv = _logic_statement(rng, 10)
    d_gpu = flat_sha256(flatten_proof(_prove(rows, ctls, pv, config, dev)))
    d_cpu = flat_sha256(flatten_proof(_prove(rows, ctls, pv, config, "cpu")))
    log(f"[proof] Logic 2^10 digest card {d_gpu} == CPU {d_cpu}: "
        f"{d_gpu == d_cpu}")
    if d_gpu != d_cpu:
        raise AssertionError("card and CPU proofs differ")

    with open(GOLDEN) as f:
        v = json.load(f)["logic_proof"]
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    ctls = [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]
    pv = PublicValues(MemRoots.from_image_id(bytes([3] * 32)),
                      MemRoots.from_image_id(bytes([4] * 32)), bytes(32))
    rows = logic.generate_rows([tuple(o) for o in v["ops"]], min_rows=16)
    golden = flat_sha256(flatten_proof(_prove(
        rows, ctls, pv, StarkConfig.test_config(), dev)))
    log(f"[proof] frozen logic_proof on the card: {golden == v['sha256_flat']}")
    if golden != v["sha256_flat"]:
        raise AssertionError("frozen logic_proof does not reproduce")


def _toy_segment(dev):
    """The toy program's one segment, split by the port's emulator on
    `dev` (its page hashing: K1)."""
    from zkm_tpu_torch.emulator.state import State
    from zkm_tpu_torch.emulator.utils import split_prog_into_segs
    st = State(dev)
    st.memory.set_memory_range(0, b"".join(w.to_bytes(4, "big")
                                           for w in TOY_PROGRAM))
    _, segs, _ = split_prog_into_segs(st, seg_size=1 << 20)
    return segs[0]


def _same_witness(a, b) -> bool:
    from zkm_tpu_torch.witness.trace_set import pack
    a, b = pack(a), pack(b)
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and np.array_equal(a[k], b[k]) for k in a)


def _reject_tampered(proof, all_stark=None) -> str:
    """The port's verifier on a copy with one Cpu opening changed; returns
    its error."""
    import copy
    from zkm_tpu_torch import host
    bad = copy.deepcopy(proof)
    vals = bad.stark_proofs[1].proof.openings.local_values
    vals[0, 0] = (int(vals[0, 0]) + 1) % P
    try:
        host.verify_segment(bad, all_stark=all_stark)
    except ValueError as e:
        return str(e)
    raise AssertionError("the verifier accepted a tampered proof")


def check_toy_segment(dev) -> None:
    """(a) the toy segment from program bytes through the port's emulator
    and host.prove_segment at natural heights: its witness, public values
    and flattened sha256 against zkm_tpu's."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.stark.all_stark import make_all_stark
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.witness.trace_set import load_toy_segment

    frozen, pv_ref, ref = load_toy_segment()
    timer = LaunchTimer(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.step("emulate"):
        seg = _toy_segment(dev)
    proof = host.prove_segment(seg, device=dev, timer=timer).proof
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    heights = [p.degree_bits for p in proof.stark_proofs]
    digest = flat_sha256(flatten_proof(proof))
    same_pv = host.public_values_for_segment(seg) == pv_ref
    same_ts = _same_witness(
        host.segment_witness(seg, make_all_stark(), device=dev), frozen)
    log(f"[segment] toy program -> split_prog_into_segs -> prove_segment at "
        f"natural heights 2^{heights}: {wall:.3f} s ({timer.report()}); "
        f"launches {launches}")
    log(f"[segment] toy witness == frozen npz field for field: {same_ts}; "
        f"public values == zkm_tpu's: {same_pv}; flattened sha256 {digest} "
        f"== zkm_tpu's {ref['sha256_flat']}: {digest == ref['sha256_flat']}")
    if not (same_ts and same_pv) or heights != ref["natural_heights_log2"] \
            or digest != ref["sha256_flat"]:
        raise AssertionError("toy segment differs from zkm_tpu's")
    host.verify_segment(proof)
    log(f"[segment] verified by the port's verifier; a copy with one Cpu "
        f"opening changed is rejected ({_reject_tampered(proof)})")


def prove_hello_heights(ts, pv, dev) -> None:
    """(b) the frozen toy witness at a hello segment's heights: one proof,
    verified."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.stark.all_stark import Table

    floors = {Table[name]: 1 << log_n for name, log_n, _ in SEGMENT_TABLES}
    timer = LaunchTimer(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = host.prove_trace_set(ts, pv, height_floors=floors, device=dev,
                                 timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    heights = [p.degree_bits for p in proof.stark_proofs]
    log(f"[segment] frozen toy witness at hello heights 2^{heights}: wall "
        f"{wall:.3f} s ({timer.report()}); launches {launches}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    host.verify_segment(proof)
    log("[segment] verified by the port's verifier")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")


def phase_segment(dev) -> None:
    from zkm_tpu_torch.witness.trace_set import load_toy_segment
    check_toy_segment(dev)
    ts, pv, _ = load_toy_segment()
    prove_hello_heights(ts, pv, dev)


def run_memalloc(dev, timer=None, mesh=None):
    """The main path: assemble the memalloc guest, split it ("emulate") and
    prove each segment with host.prove_segment (over `mesh`'s tp group if
    given).  Returns (total steps, segments, receipts)."""
    from zkm_tpu_torch import host
    from zkm_tpu_torch.emulator.state import State
    from zkm_tpu_torch.emulator.utils import split_prog_into_segs
    from zkm_tpu_torch.runtime.examples import build_memalloc_guest
    from zkm_tpu_torch.utils.timing import step

    with step(timer, "emulate"):
        st = State(dev)
        st.memory.set_memory_range(0, build_memalloc_guest(*MEMALLOC_ARGS))
        total, segs, _ = split_prog_into_segs(st, seg_size=MEMALLOC_SEG_SIZE)
    receipts = [host.prove_segment(s, device=dev, timer=timer, mesh=mesh)
                for s in segs]
    host.check_receipt_chain(receipts)
    return total, segs, receipts


def segment_record(seg, heights) -> dict:
    """The fields of memalloc_segment_reference.json a run can check
    without the witness."""
    from zkm_tpu_torch import host
    pv = host.public_values_for_segment(seg)
    return {
        "step": seg.step, "pc": seg.pc, "end_pc": seg.end_pc,
        "pre_image_id": seg.pre_image_id.hex(),
        "image_id": seg.image_id.hex(),
        "public_values": {"roots_before": pv.roots_before.root,
                          "roots_after": pv.roots_after.root,
                          "userdata": pv.userdata.hex()},
        "natural_heights_log2": heights}


def phase_main_path(dev, profile: bool) -> list:
    """Phase 6: the memalloc guest end to end, a first and a warm run, each
    verified and held against zkm_tpu's record.  Returns the flattened
    sha256 of each segment's proof (the runs must agree), what phase 10b
    holds its tp = 2 proof against."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.stark.all_stark import make_all_stark
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.witness.trace_set import DATA, field_digests

    with open(os.path.join(DATA, "memalloc_segment_reference.json")) as f:
        record = json.load(f)
    main, proof_sha256 = None, []
    for label in ("first", "warm"):
        timer = LaunchTimer(dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, segs, receipts = run_memalloc(dev, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        proof_sha256.append([flat_sha256(flatten_proof(r.proof))
                             for r in receipts])
        peak = torch.cuda.max_memory_allocated() / 2**30
        main = main or (launches, timer.launches)
        heights = [[p.degree_bits for p in r.proof.stark_proofs]
                   for r in receipts]
        log(f"[main] memalloc{MEMALLOC_ARGS} at seg_size 2^16, {label} run: "
            f"{total} steps, {len(segs)} segment(s), natural heights 2^"
            f"{heights}; wall {wall:.3f} s ({timer.report()}); launches "
            f"{launches}; peak device memory {peak:.2f} GiB")
        got = [segment_record(s, h) for s, h in zip(segs, heights)]
        want = [{k: r[k] for k in got[0]} for r in record["segments"]]
        same = (total, len(segs)) == (record["total_steps"],
                                      record["num_segments"]) and got == want
        log(f"[main] steps, pc, end_pc, image ids, public values and "
            f"heights == zkm_tpu's record: {same}")
        if not same:
            raise AssertionError(f"memalloc segments differ from the record: "
                                 f"{got} != {want}")
        t0 = time.perf_counter()
        for r in receipts:
            host.verify_segment_receipt(r)
        log(f"[main] {label} run's proofs verified by the port's verifier in "
            f"{time.perf_counter() - t0:.1f} s")
    all_stark = make_all_stark()
    for seg, want in zip(segs, record["segments"]):
        digests = field_digests(host.segment_witness(seg, all_stark,
                                                     device=dev))
        same = digests == want["field_digests"]
        log(f"[main] segment {seg.segment_id} witness field_digests == "
            f"zkm_tpu's record: {same}")
        if not same:
            raise AssertionError("memalloc witness differs from the record: "
                                 + ", ".join(k for k in digests if digests[k]
                                             != want["field_digests"][k]))
    launches, per_step = main
    k1_proof = launches["poseidon_permute"] - per_step["emulate"][0] \
        - per_step["witness"][0]
    if min(per_step["emulate"][0], per_step["witness"][0], k1_proof,
           launches["goldilocks_ntt"]) == 0:
        raise AssertionError(f"a kernel was not launched where it must be: "
                             f"{per_step}")
    if profile:
        profile_segment(segs[0], dev)
    log(f"[main] proofs' flattened sha256 {proof_sha256[0]}; the warm "
        f"run's are the same: {proof_sha256[1] == proof_sha256[0]}")
    if proof_sha256[1] != proof_sha256[0]:
        raise AssertionError("the first and the warm proofs differ")
    return proof_sha256[0]


def profile_segment(seg, dev, all_stark=None, label="memalloc") -> None:
    """Device time per kernel name of a warm host.prove_segment of `seg`
    (witness, trace build, proof) under torch.profiler, with the
    device-busy share of its wall time (the profiler's own overhead is
    part of that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zkm_tpu_torch import host

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.prove_segment(seg, all_stark=all_stark, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_out = []
    for e in prof.key_averages():
        # kernels and copies only: an aten op's own entry repeats the
        # device time of the kernels it launched
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            rows_out.append((e.self_device_time_total, e.count, e.key))
    rows_out.sort(reverse=True)
    device_us = sum(r[0] for r in rows_out)
    log(f"[profile] warm {label} prove_segment under the profiler: "
        f"wall {wall * 1e3:.1f} ms, device time {device_us / 1e3:.1f} ms "
        f"(busy share {device_us / 1e4 / wall:.1f}%), "
        f"{sum(r[1] for r in rows_out)} kernels and copies")
    for us, count, key in rows_out[:20]:
        log(f"[profile] {us / 1e3:9.2f} ms {count:7d}x {key[:90]}")


def _split(prog: bytes, inputs, seg_size: int, dev):
    """(total steps, segments) of a program split by the port's emulator
    on `dev`."""
    from zkm_tpu_torch.emulator.state import State
    from zkm_tpu_torch.emulator.utils import split_prog_into_segs
    st = State(dev)
    st.memory.set_memory_range(0, prog)
    for raw in inputs:
        st.add_input_stream_bytes(raw)
    total, segs, _ = split_prog_into_segs(st, seg_size=seg_size)
    return total, segs


def _check_witness(seg, all_stark, want: dict, dev, label: str) -> None:
    from zkm_tpu_torch import host
    from zkm_tpu_torch.witness.trace_set import field_digests
    digests = field_digests(host.segment_witness(seg, all_stark, device=dev))
    same = digests == want
    log(f"[witness] {label}: all {len(want)} field_digests == "
        f"zkm_tpu's record: {same}")
    if not same:
        raise AssertionError(f"{label} witness differs from the record: "
                             + ", ".join(k for k in set(digests) | set(want)
                                         if digests.get(k) != want.get(k)))


@contextlib.contextmanager
def quotient_buffers(out: list):
    """Records (slots, points) of every scheduled constraint evaluation
    (one per table and proof, in table order): its value buffer holds
    slots x points int64 values."""
    from zkm_tpu_torch.stark import expr
    plain = expr.evaluate_scheduled

    def recording(sched, trace, *args, **kwargs):
        out.append((sched.n_slots, trace.shape[-1]))
        return plain(sched, trace, *args, **kwargs)
    expr.evaluate_scheduled = recording
    try:
        yield out
    finally:
        expr.evaluate_scheduled = plain


def check_full_segment(dev) -> None:
    """Phase 7a: the full guest at natural heights under FULL_SUBSET against
    zkm_tpu's record, verified, a tampered copy rejected, and the same
    digest with debug=True."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.runtime.examples import build_full_guest
    from zkm_tpu_torch.stark.all_stark import FULL_SUBSET, make_all_stark
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "full_segment_reference.json")) as f:
        record = json.load(f)
    all_stark = make_all_stark(FULL_SUBSET)
    timer = LaunchTimer(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.step("emulate"):
        total, segs = _split(build_full_guest(), (), FULL_SEG_SIZE, dev)
    receipt = host.prove_segment(segs[0], all_stark=all_stark, device=dev,
                                 timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    heights = [p.degree_bits for p in receipt.proof.stark_proofs]
    digest = flat_sha256(flatten_proof(receipt.proof))
    want = record["segment"]
    got = segment_record(segs[0], heights)
    same = (total, len(segs)) == (record["total_steps"], 1) and \
        got == {k: want[k] for k in got}
    log(f"[full] full guest -> prove_segment(FULL_SUBSET), 12 tables and "
        f"{len(all_stark.ctls)} CTLs at natural heights 2^{heights}: "
        f"{wall:.3f} s ({timer.report()}); launches {launches}")
    log(f"[full] steps, image ids, public values and heights == zkm_tpu's "
        f"record: {same}; flattened sha256 {digest} == zkm_tpu's "
        f"{record['sha256_flat']}: {digest == record['sha256_flat']}")
    if not same or digest != record["sha256_flat"]:
        raise AssertionError("full guest's proof differs from zkm_tpu's")
    _check_witness(segs[0], all_stark, want["field_digests"], dev,
                   "full guest")
    host.verify_segment_receipt(receipt, all_stark=all_stark)
    log(f"[full] verified by the port's verifier; a copy with one Cpu "
        f"opening changed is rejected "
        f"({_reject_tampered(receipt.proof, all_stark)})")
    t0 = time.perf_counter()
    debug = host.prove_segment(segs[0], all_stark=all_stark, device=dev,
                               debug=True)
    debug_digest = flat_sha256(flatten_proof(debug.proof))
    log(f"[full] debug=True (constraints checked on every table's rows): "
        f"{time.perf_counter() - t0:.3f} s, same digest: "
        f"{debug_digest == digest}")
    if debug_digest != digest:
        raise AssertionError("debug=True changed the proof")


def phase_hash_segment(dev, profile: bool) -> dict:
    """Phase 7b, this slice's main path: the hash-heavy guest end to end
    under FULL_SUBSET, a first and a warm run, each verified and held
    against zkm_tpu's record.  Returns the first run's launches."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.runtime.examples import (build_hash_guest,
                                                hash_guest_input)
    from zkm_tpu_torch.stark.all_stark import FULL_SUBSET, make_all_stark
    from zkm_tpu_torch.utils.timing import step
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "hash_segment_reference.json")) as f:
        record = json.load(f)
    all_stark = make_all_stark(FULL_SUBSET)
    prog, inputs = build_hash_guest(), (hash_guest_input(),)
    main = None
    for label in ("first", "warm"):
        timer = LaunchTimer(dev, step_peaks=True)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quotient_buffers([]) as buffers:
            with step(timer, "emulate"):
                total, segs = _split(prog, inputs, HASH_SEG_SIZE, dev)
            receipts = [host.prove_segment(s, all_stark=all_stark,
                                           device=dev, timer=timer)
                        for s in segs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        main = main or (launches, timer.launches)
        heights = [[p.degree_bits for p in r.proof.stark_proofs]
                   for r in receipts]
        log(f"[hash] build_hash_guest() at seg_size 2^16, {label} run: "
            f"{total} steps, {len(segs)} segment(s), natural heights 2^"
            f"{heights}; wall {wall:.3f} s ({timer.report()}); launches "
            f"{launches}; peak device memory "
            f"{max(timer.peak_gib.values()):.2f} GiB")
        log("[hash] quotient buffers: " + ", ".join(
            f"{t.name} {s} slots x {m} points = {s * m * 8 / 2**30:.2f} GiB"
            for t, (s, m) in zip(all_stark.tables, buffers)))
        got = [segment_record(s, h) for s, h in zip(segs, heights)]
        want = [{k: r[k] for k in got[0]} for r in record["segments"]]
        same = (total, len(segs)) == (record["total_steps"],
                                      record["num_segments"]) and got == want
        log(f"[hash] steps, pc, end_pc, image ids, public values and "
            f"heights == zkm_tpu's record: {same}")
        if not same:
            raise AssertionError(f"hash segment differs from the record: "
                                 f"{got} != {want}")
        t0 = time.perf_counter()
        for r in receipts:
            host.verify_segment_receipt(r, all_stark=all_stark)
        log(f"[hash] {label} run's proofs verified by the port's verifier "
            f"in {time.perf_counter() - t0:.1f} s")
    for seg, want in zip(segs, record["segments"]):
        _check_witness(seg, all_stark, want["field_digests"], dev,
                       f"hash segment {seg.segment_id}")
    launches, per_step = main
    k1_proof = launches["poseidon_permute"] - per_step["emulate"][0] \
        - per_step["witness"][0]
    if min(per_step["emulate"][0], per_step["witness"][0], k1_proof,
           launches["goldilocks_ntt"]) == 0:
        raise AssertionError(f"a kernel was not launched where it must be: "
                             f"{per_step}")
    if profile:
        profile_segment(segs[0], dev, all_stark, "hash segment")
    return launches


# -- phase 8: receipts, composition and recursion --------------------------

def _recursion_config():
    """tests/test_recursion_aggregate.py:_rconfig (2 queries, cap 1, arity
    2), phase 8a's inner and shrink config."""
    from zkm_tpu_torch.fri.config import FriConfig
    from zkm_tpu_torch.stark.config import StarkConfig
    return StarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=FriConfig(rate_bits=2, cap_height=1, proof_of_work_bits=1,
                             num_query_rounds=2, arity_bits=2,
                             final_poly_bits=3))


def _roots(a: int, b: int):
    from zkm_tpu_torch.stark.proof import MemRoots, PublicValues
    return PublicValues(MemRoots.from_image_id(bytes([a] * 32)),
                        MemRoots.from_image_id(bytes([b] * 32)), bytes(32))


def _expect(what: str, got, want, whose: str = "zkm_tpu's") -> None:
    shown = str(got)
    shown = shown if len(shown) <= 400 else shown[:400] + "..."
    log(f"[check] {what}: {shown} == {whose}: {got == want}")
    if got != want:
        raise AssertionError(f"{what} differs from {whose}: {got} "
                             f"!= {want}")


def _dag_counts(circuit) -> dict:
    dag = circuit.vdag.dag
    return {"n": dag.n, "prog_len": len(dag.prog),
            "num_poseidons": dag.num_poseidons}


def _reject_tampered_claim(circuit, proof) -> str:
    """verify_shrink on a copy whose claimed roots_before changed; returns
    its error."""
    import copy
    from zkm_tpu_torch.recursion.shrink import verify_shrink
    bad = copy.deepcopy(proof)
    root = bad.public_values.roots_before.root
    root[0] = (int(root[0]) + 1) % P
    try:
        verify_shrink(circuit, bad)
    except ValueError as e:
        return str(e)
    raise AssertionError("verify_shrink accepted a tampered claim")


def check_recursion_toy(dev) -> None:
    """Phase 8a: tests/test_recursion_aggregate.py's statement on the card,
    bit for bit against zkm_tpu's record; then a composite receipt of the
    composition guest."""
    from zkm_tpu_torch.convert import traces_from_rows
    from zkm_tpu_torch.recursion.aggregate import AggregationTree
    from zkm_tpu_torch.recursion.shrink import (build_shrink_circuit,
                                                verify_shrink)
    from zkm_tpu_torch.stark.cross_table_lookup import (CrossTableLookup,
                                                        TableWithColumns)
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.stark.prover import prove_with_traces
    from zkm_tpu_torch.tables import logic
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "recursion_toy_reference.json")) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    config = _recursion_config()
    cols, filt = tuple(logic.ctl_data()), logic.ctl_filter()
    ctls = [CrossTableLookup((TableWithColumns(0, cols, filt),),
                             TableWithColumns(0, cols, filt))]
    starks = [logic.LogicStark()]
    rows = logic.generate_rows([tuple(o) for o in record["ops"]],
                               min_rows=record["min_rows"])
    inner = [prove_with_traces(starks, config, traces_from_rows([rows], dev),
                               ctls, _roots(tag, tag + 1), device=dev)
             for tag in (0, 1)]
    digest = lambda p: flat_sha256(flatten_proof(p))  # noqa: E731
    _expect("8a inner proofs' sha256", [digest(p) for p in inner],
            record["inner_sha256_flat"])
    circuit = build_shrink_circuit(starks, ctls, config, inner[0],
                                   device=dev)
    want = record["shrink_circuit"]
    _expect("8a shrink DAG (wires, ops, Poseidons)", _dag_counts(circuit),
            {k: want[k] for k in ("n", "prog_len", "num_poseidons")})
    _expect("8a shrink program cap", circuit.program_cap.tolist(),
            want["program_cap"])
    tree = AggregationTree(circuit, disk_cache=False, device=dev)
    leaves = [tree.shrink(p) for p in inner]
    _expect("8a shrink proofs' sha256", [digest(lf.proof) for lf in leaves],
            record["shrink_sha256_flat"])
    log(f"[recursion] 8a shrink proofs verified; a tampered claim is "
        f"rejected ({_reject_tampered_claim(circuit, leaves[0].proof)})")
    node = tree.node_circuit(leaves[0], leaves[1])
    _expect("8a node program cap", node.program_cap.tolist(),
            record["node_circuit"]["program_cap"])
    root = tree.aggregate(leaves)
    verify_shrink(node, root.proof)
    _expect("8a root sha256", digest(root.proof), record["root_sha256_flat"])
    log(f"[recursion] 8a in {time.perf_counter() - t0:.1f} s")
    check_composition(dev)


def check_composition(dev) -> None:
    """The composition guest (runtime.examples.build_composition_guest)
    under Cpu/Logic/Memory and test_config: SYS_VERIFY consumes a claim,
    host.prove_segments_with_assumptions returns a composite receipt that
    receipts.verify_receipt accepts, and rejects with the assumption
    unresolved."""
    from zkm_tpu_torch import host
    from zkm_tpu_torch import receipts as rc
    from zkm_tpu_torch.runtime.examples import build_composition_guest
    from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
    from zkm_tpu_torch.stark.config import StarkConfig

    t0 = time.perf_counter()
    config = StarkConfig.test_config()
    all_stark = make_all_stark((Table.Cpu, Table.Logic, Table.Memory))
    claim = rc.ReceiptClaim(elf_id=b"\x07" * 32, commit=b"\x08" * 32)
    proven = rc.AssumptionReceipt(proven=rc.Receipt.segments(
        rc.InnerReceipt(segments=[], claim=claim)))
    _, segs = _split(build_composition_guest(), (rc.claim_digest(claim),),
                     FULL_SEG_SIZE, dev)
    receipt = host.prove_segments_with_assumptions(
        segs, [proven], config, all_stark, device=dev)
    if not isinstance(receipt.inner, rc.CompositeReceipt):
        raise AssertionError("SYS_VERIFY's assumption was not used")
    rc.verify_receipt(receipt, config, all_stark)
    assumption, _ = receipt.assumptions()[0]
    receipt.inner.assumptions_used[0] = (
        assumption, rc.AssumptionReceipt(unresolved=assumption))
    try:
        rc.verify_receipt(receipt, config, all_stark)
    except ValueError as e:
        log(f"[recursion] 8a composite receipt of the composition guest "
            f"({len(segs)} segment(s)) verified in "
            f"{time.perf_counter() - t0:.1f} s; with its assumption "
            f"unresolved it is rejected ({e})")
        return
    raise AssertionError("verify_receipt accepted an unresolved assumption")


def _heights(proof) -> list:
    return [p.degree_bits for p in proof.stark_proofs]


def phase_recursion(dev, profile: bool):
    """Phase 8b: two real fib segments proved, shrunk and aggregated into
    one root, each step timed with its launches and peak memory, held
    against zkm_tpu's record.  Returns the path's launches and the root's
    export document (with its program cap), what phase 9c wraps."""
    import torch
    from zkm_tpu_torch import export, host
    from zkm_tpu_torch.recursion.aggregate import AggregationTree
    from zkm_tpu_torch.recursion.shrink import (build_shrink_circuit,
                                                verify_shrink)
    from zkm_tpu_torch.runtime.examples import build_fib_guest
    from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
    from zkm_tpu_torch.stark.config import StarkConfig
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.utils.timing import step
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "recursion_fib_reference.json")) as f:
        record = json.load(f)
    config = StarkConfig.test_config()
    all_stark = make_all_stark(tuple(Table[n] for n in record["subset"]))
    digest = lambda p: flat_sha256(flatten_proof(p))  # noqa: E731
    timers = {name: LaunchTimer(dev, step_peaks=True)
              for name in ("inner", "shrink_circuit", "shrink_0", "shrink_1",
                           "aggregate")}
    reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()

    inner_t = timers["inner"]
    with step(inner_t, "emulate"):
        total, segs = _split(build_fib_guest(FIB_N), (), FIB_SEG_SIZE, dev)
    receipts = [host.prove_segment(s, config, all_stark, device=dev,
                                   timer=inner_t) for s in segs]
    host.check_receipt_chain(receipts)
    _expect("8b fib segments (total steps, [steps, pre/post image id])",
            (total, [{"step": s.step, "pre_image_id": s.pre_image_id.hex(),
                      "image_id": s.image_id.hex()} for s in segs]),
            (record["total_steps"], record["segments"]))
    proofs = [r.proof for r in receipts]
    _expect("8b inner heights", [_heights(p) for p in proofs],
            record["inner_heights_log2"])
    _expect("8b inner proofs' sha256", [digest(p) for p in proofs],
            record["inner_sha256_flat"])
    if len({tuple(_heights(p)) for p in proofs}) != 1:
        raise AssertionError("the inner proofs' heights differ: one shrink "
                             "circuit cannot verify both")

    circuit = build_shrink_circuit(all_stark.starks, all_stark.ctls, config,
                                   proofs[0], device=dev,
                                   timer=timers["shrink_circuit"])
    want = record["shrink_circuit"]
    _expect("8b shrink DAG (wires, ops, Poseidons)", _dag_counts(circuit),
            {k: want[k] for k in ("n", "prog_len", "num_poseidons")})
    _expect("8b shrink program cap (verifying key)",
            circuit.program_cap.tolist(), want["program_cap"])

    tree = AggregationTree(circuit, disk_cache=False, device=dev)
    leaves = [tree.shrink(p, timers[f"shrink_{i}"])
              for i, p in enumerate(proofs)]
    _expect("8b shrink heights (VM, WireMem, PoseidonCall, Poseidon, "
            "Program)", [_heights(lf.proof) for lf in leaves],
            [[t["log2_rows"] for t in tr] for tr in record["shrink_traces"]])
    if record.get("shrink_sha256_flat"):
        _expect("8b shrink 0's sha256", digest(leaves[0].proof),
                record["shrink_sha256_flat"])
    else:
        log(f"[recursion] 8b shrink 0's sha256 {digest(leaves[0].proof)}: "
            f"no zkm_tpu value ({record['shrink_note']})")

    agg_t = timers["aggregate"]
    root = tree.aggregate_pair(leaves[0], leaves[1], agg_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    node = tree.circuit_for(root)
    verify_shrink(node, root.proof)
    pv, pv0, pv1 = (root.proof.public_values, proofs[0].public_values,
                    proofs[1].public_values)
    chained = (pv.roots_before == pv0.roots_before
               and pv.roots_after == pv1.roots_after
               and pv.userdata == pv0.userdata == pv1.userdata)
    log(f"[recursion] 8b root claims (segment 0's roots_before, segment 1's "
        f"roots_after, userdata): {chained}; verified by verify_shrink; a "
        f"tampered claim is rejected "
        f"({_reject_tampered_claim(node, root.proof)})")
    if not chained:
        raise AssertionError("the root's claim is not the chained claim")

    log(f"[recursion] 8b circuits: shrink DAG {_dag_counts(circuit)}, "
        f"aggregation DAG {_dag_counts(node)}")
    log(f"[recursion] 8b heights: shrink 0 2^{_heights(leaves[0].proof)}, "
        f"shrink 1 2^{_heights(leaves[1].proof)}, root "
        f"2^{_heights(root.proof)} (VM, WireMem, PoseidonCall, Poseidon, "
        f"Program)")
    for name, t in timers.items():
        log(f"[recursion] 8b {name}: {sum(t.seconds.values()):.3f} s "
            f"({t.report()})")
    log(f"[recursion] 8b fib({FIB_N}) 2 segments -> 2 shrinks -> root: "
        f"{wall:.3f} s; launches {launches}; peak device memory "
        f"{max(max(t.peak_gib.values()) for t in timers.values()):.2f} GiB")
    if not all(launches.values()) or not all(
            timers[n].launches.get("trace_commit", [0, 0])[0]
            for n in ("shrink_0", "shrink_1", "aggregate")):
        raise AssertionError(f"a kernel was not launched where it must be: "
                             f"{launches}, {timers['aggregate'].launches}")
    if profile:
        profile_root(node, leaves, dev)
    return launches, export.export_proof(root.proof, config,
                                         program_cap=node.program_cap)


def profile_root(node, leaves, dev) -> None:
    """Device time per kernel name of the root's prove_aggregation under
    torch.profiler, with its device-busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zkm_tpu_torch.recursion.shrink import prove_aggregation

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove_aggregation(node, [lf.proof for lf in leaves], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_out = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
    rows_out.sort(reverse=True)
    device_us = sum(r[0] for r in rows_out)
    log(f"[profile] root prove_aggregation under the profiler: wall "
        f"{wall * 1e3:.1f} ms, device time {device_us / 1e3:.1f} ms (busy "
        f"share {device_us / 1e4 / wall:.1f}%), "
        f"{sum(r[1] for r in rows_out)} kernels and copies")
    for us, count, key in rows_out[:20]:
        log(f"[profile] {us / 1e3:9.2f} ms {count:7d}x {key[:90]}")


def phase_recursion_all(dev, profile: bool):
    t0 = time.perf_counter()
    check_recursion_toy(dev)
    out = phase_recursion(dev, profile)
    log(f"[recursion] phase 8 in {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 9: the program-to-on-chain pipeline --------------------------------

CLI_LAUNCHES = re.compile(r"launches: K1 (\d+), K2 (\d+)")


def run_cli(cmd: str, env: dict):
    """(stdout, launches) of `python -m zkm_tpu_torch.cli cmd` on the card
    (no DEVICE) with `env` added, logged with its seconds; raises if it
    fails."""
    full = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zkm_tpu_torch.cli", cmd],
                          cwd=HERE, env={**full, **env}, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    out = proc.stdout
    if proc.returncode != 0:
        raise AssertionError(f"cli {cmd} failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    m = CLI_LAUNCHES.search(out)
    launches = {"poseidon_permute": int(m[1]), "goldilocks_ntt": int(m[2])} \
        if m else {}
    log(f"[cli] {cmd}: {seconds:.1f} s of command time; "
        + " | ".join(out.strip().splitlines()))
    return out, launches


def phase_cli(tmp: str) -> dict:
    """Phase 9a: the env-var CLI as a user runs it, each command a process
    on the card: split-seg of fib(40)'s ELF at SEG_SIZE 1800 (files
    byte-equal to zkm_tpu.cli's, data/cli_reference.json), prove-seg of
    segment 0 and prove-elf of the ELF, each receipt verified.  Returns
    the launches the commands report."""
    from zkm_tpu_torch.runtime.examples import build_fib_guest, guest_elf
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "cli_reference.json")) as f:
        record = json.load(f)
    with open(os.path.join(DATA, "recursion_fib_reference.json")) as f:
        fib = json.load(f)
    elf, segs = os.path.join(tmp, "fib.elf"), os.path.join(tmp, "segs")
    with open(elf, "wb") as f:
        f.write(guest_elf(build_fib_guest(FIB_N)))
    t0 = time.perf_counter()
    _, split = run_cli("split-seg", {"ELF_PATH": elf, "SEG_OUTPUT": segs,
                                     "SEG_SIZE": str(record["seg_size"])})
    files, got = {}, []
    for name in sorted(os.listdir(segs), key=int):
        with open(os.path.join(segs, name), "rb") as f:
            data = f.read()
        files[name] = hashlib.sha256(data).hexdigest()
        seg = json.loads(data)
        got.append({"step": seg["step"],
                    "pre_image_id": bytes(seg["pre_image_id"]).hex(),
                    "image_id": bytes(seg["image_id"]).hex()})
    _expect("9a split-seg's segment files (sha256) == zkm_tpu.cli's",
            files, record["files_sha256"])
    _expect("9a split-seg's segments (steps, image ids)", got,
            record["segments"])
    _expect("9a steps of the ELF's segments == 8b's raw fib segments",
            [g["step"] for g in got], [g["step"] for g in fib["segments"]])
    out, prove_seg = run_cli("prove-seg",
                             {"SEG_FILE": os.path.join(segs, "0")})
    want = f"segment 0 proved and verified; image id {got[0]['image_id']}"
    if want not in out:
        raise AssertionError(f"prove-seg printed no `{want}`")
    out, prove_elf = run_cli("prove-elf", {"ELF_PATH": elf})
    want = f"final image id {got[-1]['image_id']}"
    if want not in out:
        raise AssertionError(f"prove-elf printed no `{want}`")
    launches = {k: split[k] + prove_seg[k] + prove_elf[k] for k in split}
    if not (split["poseidon_permute"] and all(prove_seg.values())
            and all(prove_elf.values())):
        raise AssertionError(f"a CLI command launched no kernel: split "
                             f"{split}, prove-seg {prove_seg}, prove-elf "
                             f"{prove_elf}")
    log(f"[cli] 9a in {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def phase_native(dev, tmp: str) -> dict:
    """Phase 9b: the native C++ core on the card: the memalloc guest's
    2^16-cycle split (and the other cases of data/native_segments_
    reference.json) against zkm_tpu's native record, its last image id
    against the Python path's (phase 6's record), emulate seconds native
    against Python, and one native segment proved and verified.  Returns
    the launches of the native split and proof."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.emulator import native
    from zkm_tpu_torch.emulator.state import State
    from zkm_tpu_torch.emulator.utils import (load_elf_with_patch,
                                              split_prog_into_segs)
    from zkm_tpu_torch.runtime import examples
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "native_segments_reference.json")) as f:
        record = json.load(f)["cases"]
    with open(os.path.join(DATA, "memalloc_segment_reference.json")) as f:
        python_record = json.load(f)
    t0 = time.perf_counter()
    native.load_core()
    log(f"[native] core built with g++ and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({native.library_path()})")

    def split(case: str, use_native: bool = True):
        want = record[case]
        name, args = want["guest"].split("(")
        args = [int(a) for a in args.rstrip(")").split(",") if a.strip()]
        prog = getattr(examples, name)(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if want["elf"]:
            path = os.path.join(tmp, f"{case}.elf")
            with open(path, "wb") as f:
                f.write(examples.guest_elf(prog))
            st = load_elf_with_patch(path, [], dev, native=use_native)
        else:
            st = State(dev, native=use_native)
            st.memory.set_memory_range(0, prog)
        if name == "build_hash_guest":
            st.add_input_stream_bytes(examples.hash_guest_input())
        total, segs, final = split_prog_into_segs(st,
                                                  seg_size=want["seg_size"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {"total_steps": total, "exit_code": final.exit_code,
               "segments": [{"step": s.step, "pc": s.pc, "end_pc": s.end_pc,
                             "pre_image_id": s.pre_image_id.hex(),
                             "image_id": s.image_id.hex(),
                             "file_sha256": hashlib.sha256(
                                 s.to_json().encode()).hexdigest()}
                            for s in segs]}
        return got, segs, seconds

    reset_launches()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    got, _, native_s = split("memalloc")
    _expect("9b memalloc's native split (steps, pcs, image ids, files) == "
            "zkm_tpu's native record",
            got, {k: record["memalloc"][k] for k in got})
    _expect("9b memalloc's last image id == the Python path's (phase 6's "
            "record)", got["segments"][-1]["image_id"],
            python_record["segments"][-1]["image_id"])
    got, segs, seconds = split("memalloc_2^14")
    _expect("9b memalloc_2^14's native split == zkm_tpu's native record", got,
            {k: record["memalloc_2^14"][k] for k in got})
    log(f"[native] memalloc_2^14: {len(segs)} native segments in "
        f"{seconds:.3f} s")
    seg = segs[1]
    timer = LaunchTimer(dev)
    receipt = host.prove_segment(seg, device=dev, timer=timer)
    host.verify_segment_receipt(receipt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_path
    launches = read_launches()
    log(f"[native] native segment {seg.segment_id} of memalloc at seg_size "
        f"2^14 ({seg.step} steps, from pc {seg.pc:#x}) proved and verified "
        f"({timer.report()})")
    if not all(launches.values()):
        raise AssertionError(f"9b launched no kernel of {launches}")
    _, _, python_s = split("memalloc", use_native=False)
    log(f"[native] emulate memalloc{MEMALLOC_ARGS} at 2^16 cycles (61,461 "
        f"steps, page hashing on K1): native {native_s:.3f} s, Python "
        f"{python_s:.3f} s")
    for case in ("fib_elf", "hash"):
        got, _, seconds = split(case)
        _expect(f"9b {case}'s native split == zkm_tpu's native record", got,
                {k: record[case][k] for k in got})
        log(f"[native] {case}: {len(got['segments'])} native segment(s) in "
            f"{seconds:.3f} s")
    log(f"[native] 9b path (native splits + one proof) {wall:.1f} s; "
        f"launches {launches}")
    return launches


def read_wrapped_json(text: str):
    """The Groth16 proof and public inputs of `cli wrap`'s
    snark_proof_with_public_inputs.json (WrappedProof.to_json's layout)."""
    from zkm_tpu_torch.snark import bn254 as c, groth16 as g16
    d = json.loads(text)
    pf = d["proof"]
    a, cc = ((c.FQ(int(x)), c.FQ(int(y))) for x, y in (pf["a"], pf["c"]))
    b = tuple(c.FQ2([int(v) for v in xy]) for xy in pf["b"])
    return g16.Proof(a=a, b=b, c=cc), [int(v) for v in d["public_inputs"]]


def phase_wrap(root_doc: dict, tmp: str) -> None:
    """Phase 9c: the STARK -> Groth16 wrap on the host with one seeded key:
    the record's fixed document bit for bit against zkm_tpu's
    (data/wrap_reference.json), then phase 8b's root wrapped through `cli
    wrap` (the key read from ZKM_CIRCUIT_CACHE): it verifies, a changed
    public input is rejected."""
    from zkm_tpu_torch.snark import contract, groth16 as g16, mimc, wrap
    from zkm_tpu_torch.witness.trace_set import DATA

    with open(os.path.join(DATA, "wrap_reference.json")) as f:
        record = json.load(f)
    with open(os.path.join(DATA, "recursion_toy_reference.json")) as f:
        fixed_doc = json.loads(json.load(f)["root_proof_json"])
    t0 = time.perf_counter()
    pk = wrap.groth16_setup(seed=bytes.fromhex(record["setup_seed"]))
    wrap.save_proving_key(pk, tmp)
    log(f"[wrap] seeded setup of the wrap circuit (4,572 constraints): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fixed = wrap.wrap_stark_bn254(
        fixed_doc, pk, blind_seed=bytes.fromhex(record["blind_seed"]))
    sol = contract.emit_verifier_sol(pk.vk)
    _expect("9c seeded wrap of the record's document (vk via verifier.sol, "
            "proof a/b/c, public inputs) == zkm_tpu's",
            (hashlib.sha256(sol.encode()).hexdigest(), fixed.to_json()),
            (record["verifier_sol_sha256"], record["proof_json"]))
    log(f"[wrap] record's document: prove + verify "
        f"{time.perf_counter() - t0:.1f} s")

    doc_path, out_dir = (os.path.join(tmp, "root.json"),
                         os.path.join(tmp, "wrap"))
    with open(doc_path, "w") as f:
        json.dump(root_doc, f)
    run_cli("wrap", {"PROOF_JSON": doc_path, "OUTPUT_DIR": out_dir,
                     "ZKM_CIRCUIT_CACHE": tmp})
    with open(os.path.join(out_dir, "snark_proof_with_public_inputs.json")) \
            as f:
        cli_proof, cli_publics = read_wrapped_json(f.read())
    with open(os.path.join(out_dir, "verifier.sol")) as f:
        cli_sol = f.read()
    t0 = time.perf_counter()
    ok = g16.verify(pk.vk, cli_publics, cli_proof)
    verify_s = time.perf_counter() - t0
    changed = [cli_publics[0], cli_publics[1] ^ 1] + cli_publics[2:]
    rejected = not g16.verify(pk.vk, changed, cli_proof)
    digest = mimc.hash_elements(wrap.claim_limbs(root_doc))
    log(f"[wrap] cli wrap of 8b's root: its proof verifies: {ok} "
        f"({verify_s:.2f} s); a changed public input is rejected: "
        f"{rejected}; public_inputs[0] == MiMC(claim limbs): "
        f"{cli_publics[0] == digest}; verifier.sol == the key's, with "
        f"{cli_sol.count('ecMulAdd(vkx,')} ecMulAdd lines for "
        f"{len(cli_publics)} public inputs")
    if not (ok and rejected and cli_publics[0] == digest and cli_sol == sol
            and cli_sol.count("ecMulAdd(vkx,") == len(cli_publics)):
        raise AssertionError("cli wrap's output failed a check")


def phase_pipeline(dev, tmp: str, root_doc: dict, launches: dict) -> dict:
    """Phase 9: the CLI, the native core and the wrap.  Returns the
    launches of phases 8b and 9 added up."""
    t0 = time.perf_counter()
    cli = phase_cli(tmp)
    nat = phase_native(dev, tmp)
    phase_wrap(root_doc, tmp)
    log(f"[pipeline] phase 9 in {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + cli[k] + nat[k] for k in launches}


# -- phase 10: multi-rank proving over torch.distributed ---------------------

# One card: the ranks share cuda:0, so NCCL (which refuses two ranks on a
# card) is out and the collectives run over gloo, staged through the host.
MULTI_BACKEND = "gloo"
MULTI_LAUNCH_S = 480
# 10a: two segments of each of SEGMENT_TABLES's Cpu and Memory shapes,
# committed at rate 2, cap 4; two 2^16-row Logic traces committed, their
# quotient (alphas, no boundary selectors) and its folds.
STEP_SHAPES = (("Cpu", 16, 260), ("Memory", 19, 13))
STEP_ALPHAS, STEP_BETA, STEP_FOLDS = (3, 5), 7, (2, 4)


def _u64_sha(t) -> str:
    from zkm_tpu_torch.convert import to_u64
    return hashlib.sha256(to_u64(t).tobytes()).hexdigest()


def _step_inputs() -> dict:
    """10a's whole inputs on the host, made from one seed on every rank
    alike: {table: (2, C, N) int64}."""
    import torch
    from zkm_tpu_torch.convert import from_u64
    rng = np.random.default_rng(10)
    out = {name: from_u64(random_field(rng, (2, cols, 1 << log_n)))
           for name, log_n, cols in STEP_SHAPES}
    out["Logic"] = torch.stack([from_u64(_logic_statement(rng, 16)[0])
                                for _ in range(2)])
    return out


def _run_steps(sh, mesh, inputs: dict, timer) -> dict:
    """10a's steps, sharded over `mesh` or (mesh=None) on one card whole:
    {step: [sha256 of each output, this rank's block]}."""
    from zkm_tpu_torch.tables import logic
    dev = mesh.device if mesh is not None else timer.timer.device
    out = {}
    for name in [t for t, _, _ in STEP_SHAPES] + ["Logic"]:
        with timer.step(f"commit {name}"):
            if mesh is None:
                res = sh.commit_step(inputs[name].to(dev), 2, 4)
            else:
                res = sh.make_sharded_commit_step(mesh, 2, 4)(
                    mesh.local(inputs[name], 1))
        out[f"commit {name}"] = res
    coeffs = out["commit Logic"][0]
    with timer.step("quotient Logic"):
        if mesh is None:
            q = sh.quotient_step(logic.LogicStark(), coeffs,
                                 list(STEP_ALPHAS), 16)
        else:
            q = sh.make_sharded_quotient_step(
                mesh, logic.LogicStark(), list(STEP_ALPHAS), 16)(coeffs)
    out["quotient Logic"] = (q,)
    for ab in STEP_FOLDS:
        with timer.step(f"fold {ab}"):
            if mesh is None:
                f = sh.fri_fold_step(q[:, 0, :], STEP_BETA, ab)
            else:
                f = sh.make_sharded_fri_fold(mesh, STEP_BETA, ab)(q[:, 0, :])
        out[f"fold {ab}"] = (f,)
    return out


def _rank_report(mesh, timer, t0: float) -> dict:
    import torch
    torch.cuda.synchronize()
    return {"coords": (mesh.dp_index, mesh.tp_index),
            "wall": time.perf_counter() - t0, "report": timer.report(),
            "launches": read_launches(),
            "peak_gib": max(timer.peak_gib.values()),
            "comm": mesh.tp_comm.stats() if mesh.tp_comm.size > 1
            else mesh.dp_comm.stats()}


def _rank_steps(backend) -> dict:
    """A rank of 10a: the three sharded steps at (dp, tp) = (2, 2)."""
    from zkm_tpu_torch.parallel import sharding as sh
    mesh = sh.make_mesh(2, 2, backend=backend)
    inputs = _step_inputs()
    timer = LaunchTimer(mesh.device, step_peaks=True, comm=mesh.tp_comm)
    reset_launches()
    t0 = time.perf_counter()
    res = _run_steps(sh, mesh, inputs, timer)
    out = _rank_report(mesh, timer, t0)
    out["sha"] = {k: [_u64_sha(x) for x in v] for k, v in res.items()}
    return out


def _rank_memalloc(backend) -> dict:
    """A rank of 10b: memalloc's 2^16-cycle segment at tp = 2."""
    from zkm_tpu_torch.parallel import sharding as sh
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    mesh = sh.make_mesh(1, 2, backend=backend)
    timer = LaunchTimer(mesh.device, step_peaks=True, comm=mesh.tp_comm)
    reset_launches()
    t0 = time.perf_counter()
    _, _, receipts = run_memalloc(mesh.device, timer, mesh)
    out = _rank_report(mesh, timer, t0)
    out["sha256"] = [flat_sha256(flatten_proof(r.proof)) for r in receipts]
    out["receipts"] = receipts if mesh.rank == 0 else None
    return out


def _rank_fib() -> dict:
    """A rank of 10c: fib(40)'s two segments at (dp, tp) = (2, 1), one a
    dp group, the receipts gathered and chained."""
    from zkm_tpu_torch import host
    from zkm_tpu_torch.parallel import sharding as sh
    from zkm_tpu_torch.runtime.examples import build_fib_guest
    from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
    from zkm_tpu_torch.stark.config import StarkConfig
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof
    from zkm_tpu_torch.utils.timing import step
    mesh = sh.make_mesh(2, 1, backend=MULTI_BACKEND)
    timer = LaunchTimer(mesh.device, step_peaks=True, comm=mesh.dp_comm)
    reset_launches()
    t0 = time.perf_counter()
    with step(timer, "emulate"):
        _, segs = _split(build_fib_guest(FIB_N), (), FIB_SEG_SIZE,
                         mesh.device)
    receipts = host.prove_segments(
        segs, StarkConfig.test_config(),
        make_all_stark((Table.Cpu, Table.Logic, Table.Memory)),
        timer=timer, mesh=mesh)
    out = _rank_report(mesh, timer, t0)
    out["sha256"] = [flat_sha256(flatten_proof(r.proof)) for r in receipts]
    out["image_ids"] = [(r.pre_image_id.hex(), r.image_id.hex())
                        for r in receipts]
    return out


def _cards(world: int) -> str:
    """How `world` ranks lie on the cards (make_mesh: rank modulo cards)."""
    import torch
    n = torch.cuda.device_count()
    if n == 1:
        return "ranks sharing cuda:0"
    if n >= world:
        return "one card per rank"
    return f"{world} ranks on {n} cards"


def _rank_default_mesh() -> None:
    """A rank that asks make_mesh for its default backend (NCCL on cards)."""
    from zkm_tpu_torch.parallel import sharding as sh
    sh.make_mesh(1, 2)


def _launch(label: str, fn, world: int, args=(), backend=MULTI_BACKEND,
            layout: str = ""):
    """fn on `world` ranks of a `backend` group (parallel.launch), its
    ranks' reports logged; the parent's cached device memory is released
    first."""
    import torch
    from zkm_tpu_torch.parallel.launch import launch
    torch.cuda.empty_cache()
    log(f"[multi] {label}: {world} ranks, backend={backend}, {layout}")
    t0 = time.perf_counter()
    out = launch(fn, world, args, timeout=MULTI_LAUNCH_S, backend=backend)
    wall = time.perf_counter() - t0
    for r, o in enumerate(out):
        log(f"[multi] {label} rank {r} (dp, tp) = {o['coords']}: "
            f"{o['wall']:.3f} s; {o['report']}; launches {o['launches']}; "
            f"peak {o['peak_gib']:.2f} GiB; collectives {o['comm'][0]}: "
            f"{o['comm'][1] / 2**20:.1f} MiB in {o['comm'][2]:.3f} s")
        if not all(o["launches"].values()):
            raise AssertionError(f"{label} rank {r} launched no kernel of "
                                 f"{o['launches']}")
    log(f"[multi] {label}: launch {wall:.1f} s (the ranks' process start, "
        f"imports and card context included)")
    return out


def phase_multi_steps(dev, backend=MULTI_BACKEND) -> list:
    """10a: the three sharded steps at (dp, tp) = (2, 2) against the same
    steps on one card, each rank's blocks by sha256."""
    import torch
    from zkm_tpu_torch.parallel import sharding as sh
    inputs = _step_inputs()
    timer = LaunchTimer(dev, step_peaks=True)
    t0 = time.perf_counter()
    whole = _run_steps(sh, None, inputs, timer)
    log(f"[multi] 10a one card, whole: {time.perf_counter() - t0:.3f} s; "
        f"{timer.report()}")
    blocks = {}
    for d in range(2):
        for t in range(2):
            m = sh.Mesh(dp=2, tp=2, dp_index=d, tp_index=t, device=dev,
                        tp_comm=None, dp_comm=None)
            # coefficients: column shards; digests, quotient, folds: blocks
            # of rows or points; caps: whole
            want = {}
            for k, v in whole.items():
                if k.startswith("commit"):
                    want[k] = [_u64_sha(m.local(v[0], 1)),
                               _u64_sha(m.local(v[1], 1, even=True)),
                               _u64_sha(v[2][m.dp_block(2)])]
                else:
                    want[k] = [_u64_sha(m.local(v[0], v[0].dim() - 1,
                                                even=True))]
            blocks[(d, t)] = want
    del whole, inputs
    out = _launch("10a steps", _rank_steps, 4, (backend,), backend,
                  f"{_cards(4)}, (dp, tp) = (2, 2)")
    for o in out:
        same = o["sha"] == blocks[o["coords"]]
        log(f"[check] 10a rank {o['coords']}: its blocks of "
            f"{', '.join(o['sha'])} (sha256) == one card's: {same}")
        if not same:
            raise AssertionError(f"10a rank {o['coords']} differs from one "
                                 f"card: {o['sha']} != {blocks[o['coords']]}")
    torch.cuda.synchronize()
    return out


def phase_multi_nccl(dev, memalloc_sha256: list) -> list:
    """NCCL with one card per rank: 10a with four cards, 10b with two,
    held against one card as phase 10's gloo runs are."""
    import torch
    n = torch.cuda.device_count()
    runs = []
    if n >= 4:
        runs += phase_multi_steps(dev, "nccl")
    if n >= 2:
        got = _launch("10b memalloc, NCCL", _rank_memalloc, 2, ("nccl",),
                      "nccl", f"{_cards(2)}, (dp, tp) = (1, 2)")
        _expect("10b NCCL tp = 2 proofs", [o["sha256"] for o in got],
                [memalloc_sha256] * 2, "phase 6's one-rank proofs")
        runs += got
    return runs


def phase_multi(dev, memalloc_sha256: list) -> dict:
    """Phase 10: proving over several ranks on the card (gloo, ranks
    sharing cuda:0; with a second card also NCCL, one card per rank).
    Returns the launches of every rank added up."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.parallel.launch import LaunchError, launch
    from zkm_tpu_torch.witness.trace_set import DATA
    t_start = time.perf_counter()
    if torch.cuda.device_count() == 1:
        try:
            launch(_rank_default_mesh, 2, timeout=120)
        except LaunchError as e:
            if "NCCL needs one card per rank" not in str(e):
                raise
            log("[multi] make_mesh(1, 2) with backend=None (NCCL) on two "
                "ranks sharing one card raises: "
                f"{str(e).strip().splitlines()[-1]}")
        else:
            raise AssertionError("NCCL was let put two ranks on one card")
    runs = phase_multi_steps(dev)

    got = _launch("10b memalloc", _rank_memalloc, 2, (MULTI_BACKEND,),
                  layout=f"{_cards(2)}, (dp, tp) = (1, 2)")
    _expect("10b memalloc's tp = 2 proofs (every rank; flattened sha256)",
            [o["sha256"] for o in got], [memalloc_sha256] * 2,
            "phase 6's one-rank proofs")
    t0 = time.perf_counter()
    for r in got[0]["receipts"]:
        host.verify_segment_receipt(r)
    log(f"[multi] 10b tp = 2 proof verified by the port's verifier in "
        f"{time.perf_counter() - t0:.1f} s")
    runs += got
    if torch.cuda.device_count() >= 2:
        runs += phase_multi_nccl(dev, memalloc_sha256)
    else:
        log("[multi] one card: the NCCL run (one card per rank) waits for "
            "a machine with two")

    with open(os.path.join(DATA, "recursion_fib_reference.json")) as f:
        record = json.load(f)
    got = _launch("10c fib", _rank_fib, 2,
                  layout=f"{_cards(2)}, (dp, tp) = (2, 1)")
    want = [(s["pre_image_id"], s["image_id"]) for s in record["segments"]]
    _expect("10c fib(40) segments' inner proofs at dp = 2 (every rank: "
            "both, gathered over dp)", [o["sha256"] for o in got],
            [record["inner_sha256_flat"]] * 2)
    _expect("10c receipts chain (pre/post image ids)",
            [o["image_ids"] for o in got], [want] * 2)
    runs += got
    log(f"[multi] phase 10 in {time.perf_counter() - t_start:.1f} s")
    return {k: sum(o["launches"][k] for o in runs)
            for k in ("poseidon_permute", "goldilocks_ntt")}


def main() -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile warm phase-6 and 7b proofs and "
                        "the 8b root")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    t_start = time.perf_counter()
    phase_build()
    kernels = phase_kernels(rng, dev)
    phase_commits(rng, dev)
    phase_proof(rng, dev)
    phase_segment(dev)
    memalloc_sha256 = phase_main_path(dev, args.profile)
    check_full_segment(dev)
    phase_hash_segment(dev, args.profile)
    launches, root_doc = phase_recursion_all(dev, args.profile)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
        launches = phase_pipeline(dev, tmp, root_doc, launches)
    multi = phase_multi(dev, memalloc_sha256)
    launches = {k: launches[k] + multi[k] for k in launches}
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    for name, k in kernels.items():
        k["launches"] = launches[name]
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
