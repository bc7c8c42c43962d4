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
  5. the main path, a whole SPONGE_SUBSET segment proof from the frozen
     toy-segment witness (zkm_tpu_torch/data): (a) at its natural heights,
     whose flattened sha256 must equal zkm_tpu's, accepted by the port's
     verifier and a tampered copy rejected; (b) at a hello segment's
     heights (SEGMENT_TABLES floors), a first and a warm proof, verified,
     with per-step times, launches and peak device memory; with --profile
     also a warm (b) proof under torch.profiler: device-busy share and
     device time per kernel name.
The line before the last is {"kernels": [...]}, with the launches of the
first (b) proof; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps
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

    # The Logic path's launches (the main path's are phase 5's): counts
    # set to 0 just before, read just after.
    ps.LAUNCHES = 0
    ntt.LAUNCHES = 0
    timer = StepTimer(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = _prove(rows, ctls, pv, config, dev, timer)
    total = time.perf_counter() - t0
    launches = {"poseidon_permute": ps.LAUNCHES,
                "goldilocks_ntt": ntt.LAUNCHES}
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


def _segment_floors():
    from zkm_tpu_torch.stark.all_stark import Table
    return {Table[name]: 1 << log_n for name, log_n, _ in SEGMENT_TABLES}


def _prove_segment(ts, pv, dev, floors=None, timer=None):
    """One timed SPONGE_SUBSET proof of the witness `ts`; returns (proof,
    wall seconds, {kernel: launches in this proof})."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.field import ntt
    from zkm_tpu_torch.hash import poseidon as ps
    from zkm_tpu_torch.stark.config import StarkConfig
    ps.LAUNCHES = 0
    ntt.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = host.prove_trace_set(ts, pv, StarkConfig.standard_fast_config(),
                                 height_floors=floors, device=dev,
                                 timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return proof, wall, {"poseidon_permute": ps.LAUNCHES,
                         "goldilocks_ntt": ntt.LAUNCHES}


def check_segment_parity(ts, pv, ref, dev) -> None:
    """(a) the natural-height proof is bit-identical to zkm_tpu's, the
    port's verifier accepts it and rejects a tampered copy."""
    import copy
    from zkm_tpu_torch import host
    from zkm_tpu_torch.stark.proof import flat_sha256, flatten_proof

    proof, wall, launches = _prove_segment(ts, pv, dev)
    heights = [p.degree_bits for p in proof.stark_proofs]
    digest = flat_sha256(flatten_proof(proof))
    log(f"[segment] toy segment at natural heights 2^{heights}: "
        f"{wall:.3f} s, launches {launches}; flattened sha256 {digest} == "
        f"zkm_tpu's {ref['sha256_flat']}: {digest == ref['sha256_flat']}")
    if heights != ref["natural_heights_log2"] or \
            digest != ref["sha256_flat"]:
        raise AssertionError("segment proof differs from zkm_tpu's")
    host.verify_segment(proof)
    bad = copy.deepcopy(proof)
    vals = bad.stark_proofs[1].proof.openings.local_values
    vals[0, 0] = (int(vals[0, 0]) + 1) % P
    try:
        host.verify_segment(bad)
    except ValueError as e:
        log(f"[segment] verified by the port's verifier; a copy with one "
            f"Cpu opening changed is rejected ({e})")
    else:
        raise AssertionError("the verifier accepted a tampered proof")


def prove_hello_heights(ts, pv, dev) -> dict:
    """(b) the same witness at a hello segment's heights: a first and a
    warm proof, each verified.  Returns the first proof's launches."""
    import torch
    from zkm_tpu_torch import host
    from zkm_tpu_torch.utils.timing import StepTimer

    floors = _segment_floors()
    main_launches = None
    for label in ("first", "warm"):
        timer = StepTimer(dev)
        torch.cuda.reset_peak_memory_stats()
        proof, wall, launches = _prove_segment(ts, pv, dev, floors, timer)
        peak = torch.cuda.max_memory_allocated() / 2**30
        main_launches = main_launches or launches
        steps = ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in timer.seconds.items())
        heights = [p.degree_bits for p in proof.stark_proofs]
        log(f"[segment] hello heights 2^{heights}, {label} proof: wall "
            f"{wall:.3f} s ({steps}); launches {launches}; peak device "
            f"memory {peak:.2f} GiB")
        t0 = time.perf_counter()
        host.verify_segment(proof)
        log(f"[segment] {label} proof verified by the port's verifier in "
            f"{time.perf_counter() - t0:.1f} s")
        del proof
    if not all(main_launches.values()):
        raise AssertionError(f"a kernel was not launched: {main_launches}")
    return main_launches


def phase_segment(dev, profile: bool) -> dict:
    """The main path; returns the launches of the first hello-height
    proof."""
    from zkm_tpu_torch.witness.trace_set import load_toy_segment
    ts, pv, ref = load_toy_segment()
    check_segment_parity(ts, pv, ref, dev)
    launches = prove_hello_heights(ts, pv, dev)
    if profile:
        profile_segment(ts, pv, dev, _segment_floors())
    return launches


def profile_segment(ts, pv, dev, floors) -> None:
    """Device time per kernel name of a warm hello-height proof under
    torch.profiler, with the device-busy share of its wall time (the
    profiler's own overhead is part of that wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = _prove_segment(ts, pv, dev, floors)
    rows_out = []
    for e in prof.key_averages():
        # kernels and copies only: an aten op's own entry repeats the
        # device time of the kernels it launched
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            rows_out.append((e.self_device_time_total, e.count, e.key))
    rows_out.sort(reverse=True)
    device_us = sum(r[0] for r in rows_out)
    log(f"[profile] warm hello-height segment proof under the profiler: "
        f"wall {wall * 1e3:.1f} ms, device time {device_us / 1e3:.1f} ms "
        f"(busy share {device_us / 1e4 / wall:.1f}%), "
        f"{sum(r[1] for r in rows_out)} kernels and copies")
    for us, count, key in rows_out[:20]:
        log(f"[profile] {us / 1e3:9.2f} ms {count:7d}x {key[:90]}")


def main() -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile a warm hello-height segment proof")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    phase_build()
    kernels = phase_kernels(rng, dev)
    phase_commits(rng, dev)
    phase_proof(rng, dev)
    launches = phase_segment(dev, args.profile)
    for name, k in kernels.items():
        k["launches"] = launches[name]
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
