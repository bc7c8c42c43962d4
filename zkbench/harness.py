"""One run of one cell: set-up, the measured window, the reference's
judgement, and the result line.

`BENCHMARK.json` names each cell's configuration (`configs/<name>.json`),
traffic mix (`traffic/<mix>.json`, read by `generator.py`) and metrics;
each per-layer metric is read by `metrics/<name>.py`.  Nothing here is
particular to a cell.

The window is a closed loop with one prover: program i + 1 starts when
program i's receipts are back.  It opens at the first emulation, takes
programs while the last one's time still fits before `seconds` run out
(at least one), and closes when the last receipts are back.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import Callable, List, Optional

from . import generator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "zkm_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (zkm_tpu_torch is not zkm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    """The cell's workload entry, configuration, traffic and metrics."""
    work = {w["name"]: w for w in spec["workloads"]}[name]
    centry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    with open(os.path.join(ROOT, centry["file"])) as f:
        cfg = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])
    return {"workload": work, "config": cfg,
            "traffic": generator.load_traffic(work["traffic"]),
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def reader(metric: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"zkbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    """What the window did: per program its index, seconds, and the
    program's own segments and receipts."""

    def __init__(self):
        self.done: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.seconds = 0.0
        self.t0_ns = self.t1_ns = 0

    @property
    def proofs(self) -> int:
        return sum(len(d["receipts"]) for d in self.done)


def run_window(prove: Callable, programs, seconds: float, timer=None,
               clock=time.perf_counter) -> Window:
    w = Window()
    w.t0_ns = time.time_ns()
    t0 = clock()
    end = t0
    for prog in programs:
        start = clock()
        w.attempted += 1
        try:
            segs, receipts = prove(prog, timer)
        except Exception:
            w.failed += 1
            log(f"program {prog.index} failed:\n{traceback.format_exc()}")
            segs, receipts = None, None
        end = clock()
        if segs is not None:
            w.done.append({"index": prog.index, "program": prog,
                           "seconds": end - start, "segments": segs,
                           "receipts": receipts})
        if (end - t0) + (end - start) > seconds:
            break
    w.seconds = end - t0
    w.t1_ns = time.time_ns()
    return w


def sample_of(traffic: dict, seed: int, n_done: int) -> List[int]:
    """Which programs of the window the reference checks, drawn from the
    seed."""
    k = min(traffic.get("check_sample", 1), n_done)
    rng = generator.rng_of(seed, -1 % (1 << 32))
    return sorted(int(i) for i in rng.choice(n_done, size=k, replace=False))


def plain_outputs(window: Window, sample: List[int]) -> List[dict]:
    """The program's outputs as plain data for the reference (the sampled
    programs' proofs with them); the program's own objects are dropped."""
    from . import system
    from .reference.zkm.convert import proof_to_plain
    out = []
    for i, d in enumerate(window.done):
        receipts = []
        for r in d["receipts"]:
            pr = system.plain_receipt(r)
            if i in sample:
                pr["proof"] = proof_to_plain(r.proof)
            receipts.append(pr)
        out.append({"index": d["index"], "code": d["program"].code,
                    "inputs": d["program"].inputs,
                    "segments": [system.plain_segment(s)
                                 for s in d["segments"]],
                    "receipts": receipts})
        d["segments"] = d["receipts"] = None
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device=None, prove: Optional[Callable] = None) -> dict:
    """Set-up, window and judgement of one run; returns the result line's
    object (without `setup_s`'s reading when `device` is the CPU).
    `prove(program, timer)` replaces the port's prover (tests)."""
    from . import system
    from .reference.check import LIMITS, Judge, is_correct
    cfg, traffic = cell["config"], cell["traffic"]
    on_card = device is None
    torch = None
    if on_card:
        import torch
    prove = prove or system.Prover(cfg, device).prove
    progs = generator.programs(traffic, seed)
    prove(progs[0])                       # the warm-up, at the cell's shapes
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s")

    spans = work = prof = None
    untraced_s = None
    if trace:
        # One more untraced proof at the cell's shapes, warm: the idle share
        # is read against its time, which holds no profiler overhead.
        t0 = time.perf_counter()
        n = len(prove(progs[0])[1])
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        untraced_s = (time.perf_counter() - t0) / max(n, 1)
    t_window = time.perf_counter()
    if trace:
        spans, work = system.Spans("cuda"), system.KernelWork()
        from . import trace as tr
        prof = tr.DeviceTrace()
        with work.counting(), prof:
            window = run_window(prove, progs[1:], seconds, spans)
        log(f"trace stopped {time.perf_counter() - t_window:.1f} s after "
            f"the window opened")
    else:
        window = run_window(prove, progs[1:], seconds)
    if on_card:
        torch.cuda.synchronize()
        peak = spans.max_peak_bytes if trace else \
            torch.cuda.max_memory_allocated()
    else:
        peak = 0
    log(f"window {window.seconds:.3f} s: {window.attempted} programs, "
        f"{window.proofs} segment proofs, {window.failed} failed; peak "
        f"{peak} bytes")
    if window.done and window.done[0]["receipts"]:
        heights = [p.degree_bits for p in
                   window.done[0]["receipts"][0].proof.stark_proofs]
        log(f"heights (log2) {dict(zip(cfg['tables'], heights))}; seconds "
            f"per program {[round(d['seconds'], 3) for d in window.done]}")

    result = {"correct": False, "attempted": window.attempted,
              "failed": window.failed, "metrics": {}}
    if trace:
        t = traced(prof, window, spans, work, torch, untraced_s)
        prof = None
        result["breakdown"] = {
            "device_ops": sorted(([k[:160], v[1]] for k, v in
                                  t.kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": t.idle_gaps}
        for m in cell["per_layer"]:
            v = reader(m["name"])(t)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        busy_s, window_s = t.busy_s, t.window_s
    else:
        busy_s = window_s = None
        e2e = {"segment_proofs_per_min": window.proofs * 60 / window.seconds,
               "peak_device_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    sample = sample_of(traffic, seed, len(window.done))
    done = plain_outputs(window, sample)
    del window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = Judge(cfg).judge(
        done, sample, traffic.get("segments_per_program"), log)
    log(f"reference: {numbers['programs_checked']} program(s) checked in "
        f"{time.perf_counter() - t0:.1f} s")
    result["correct"] = is_correct(numbers) and result["failed"] == 0
    result["device"] = device_info(torch, peak, cell["workload"]["chips"])
    if trace:
        result["device"].update(busy_s=busy_s, window_s=window_s,
                                untraced_s_per_proof=untraced_s,
                                traced_s_per_proof=t.traced_s_per_proof)
    result["compared"] = {k: {"value": numbers[k], "limit": v}
                          for k, v in LIMITS.items()}
    return result


class Traced:
    """What the per-layer readers read (`metrics/<name>.py`)."""


def traced(prof, window: Window, spans, work, torch,
           untraced_s: Optional[float]) -> Traced:
    from . import trace as tr
    t0 = time.perf_counter()
    s = tr.read(prof, window.t0_ns, window.t1_ns, spans.intervals)
    log(f"trace read in {time.perf_counter() - t0:.1f} s")
    t = Traced()
    t.proofs = window.proofs
    t.window_s = (window.t1_ns - window.t0_ns) / 1e9
    t.traced_s_per_proof = t.window_s / t.proofs if t.proofs else None
    t.untraced_s_per_proof = untraced_s
    t.busy_s = s["busy_s"]
    t.device_events = s["device_events"]
    t.kernels = s["kernels"]
    t.idle_gaps = s["idle_gaps"]
    t.steps = dict(spans.seconds)
    t.step_peak_bytes = dict(spans.peak_bytes)
    t.k1_states = work.k1_states
    t.k2_int32_ops = work.k2_int32_ops
    t.k2_bytes = work.k2_bytes
    t.kind = torch.cuda.get_device_name(0)
    log(f"trace: {s['device_events']} device events in the window, "
        f"{s['events_outside_window']} outside; busy {t.busy_s:.3f} s of "
        f"{t.window_s:.3f} s; {t.traced_s_per_proof} s a traced proof, "
        f"{untraced_s} s an untraced one")
    return t


def power_limit_w() -> Optional[float]:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(torch, peak: int, chips: int) -> dict:
    if torch is None:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w()}
