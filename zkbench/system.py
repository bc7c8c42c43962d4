"""The system under test: every call the benchmark makes into
`zkm_tpu_torch`, and every counter and span it reads from it.

A program goes through the main path, as a user of the port drives it:
loaded into an `emulator.state.State`, split by
`emulator.utils.split_prog_into_segs`, and proved by
`host.prove_segments` under the configuration's StarkConfig and table
subset.  The port is imported when a `Prover` is made, never when this
module is.
"""

from __future__ import annotations

import contextlib
import time

from . import roofline


def step(timer, name: str):
    return timer.step(name) if timer is not None else contextlib.nullcontext()


class Prover:
    def __init__(self, cfg: dict, device=None):
        from zkm_tpu_torch import host, native
        from zkm_tpu_torch.emulator.state import State
        from zkm_tpu_torch.emulator.utils import split_prog_into_segs
        from zkm_tpu_torch.fri.config import FriConfig
        from zkm_tpu_torch.stark.all_stark import Table, make_all_stark
        from zkm_tpu_torch.stark.config import StarkConfig

        self.device = device
        if device is None:
            native.build()       # K1 and K2, from zkm_tpu_torch/_build/
        sc = dict(cfg["stark_config"])
        self.config = StarkConfig(security_bits=sc.pop("security_bits"),
                                  num_challenges=sc.pop("num_challenges"),
                                  fri_config=FriConfig(**sc))
        self.all_stark = make_all_stark([Table[t] for t in cfg["tables"]])
        self.seg_size = cfg["seg_size"]
        self._host, self._state, self._split = (host, State,
                                                split_prog_into_segs)

    def prove(self, program, timer=None):
        """Emulate and split the program ("emulate"), prove its segments.
        Returns (segments, receipts), the port's own objects."""
        with step(timer, "emulate"):
            st = self._state(self.device)
            st.memory.set_memory_range(0, program.code)
            for raw in program.inputs:
                st.add_input_stream_bytes(raw)
            _, segs, _ = self._split(st, None, "", self.seg_size)
        receipts = self._host.prove_segments(
            segs, self.config, self.all_stark, device=self.device,
            timer=timer)
        return segs, receipts


def plain_segment(seg) -> dict:
    return {"step": seg.step, "pc": seg.pc, "end_pc": seg.end_pc,
            "pre_image_id": bytes(seg.pre_image_id),
            "image_id": bytes(seg.image_id)}


def plain_receipt(rec) -> dict:
    return {"pre_image_id": bytes(rec.pre_image_id),
            "image_id": bytes(rec.image_id),
            "userdata": bytes(rec.userdata)}


class Spans:
    """The traced run's timer, handed to the port as its `timer`: the
    port's own `utils.timing.StepTimer` (which drains the card at each
    edge) for the seconds of each step, plus each step's interval on the
    clock the profiler's trace uses (ns since the epoch) and the peak
    device memory allocated within each step."""

    def __init__(self, device):
        import torch
        from zkm_tpu_torch.utils.timing import StepTimer
        self._torch = torch
        self.timer = StepTimer(device)
        self.seconds = self.timer.seconds
        self.intervals = []          # (step, start_ns, end_ns)
        self.peak_bytes = {}         # step -> bytes
        self.max_peak_bytes = 0

    def _peak(self) -> int:
        p = self._torch.cuda.max_memory_allocated()
        self.max_peak_bytes = max(self.max_peak_bytes, p)
        return p

    @contextlib.contextmanager
    def step(self, name: str):
        self._peak()
        self._torch.cuda.reset_peak_memory_stats()
        with self.timer.step(name):      # drains the card on entry and exit
            t0 = time.time_ns()
            yield
        self.intervals.append((name, t0, time.time_ns()))
        self.peak_bytes[name] = max(self.peak_bytes.get(name, 0),
                                    self._peak())


class KernelWork:
    """The work handed to K1 and K2 in the traced window, counted at the
    port's two launch functions (`hash/poseidon.py:_permute_cuda`,
    `field/ntt.py:_transform_cuda`) by shapes alone.  Where a later port
    has neither function, nothing is counted and the rooflines are left
    out."""

    def __init__(self):
        self.k1_states = 0
        self.k2_int32_ops = 0
        self.k2_bytes = 0

    @contextlib.contextmanager
    def counting(self):
        from zkm_tpu_torch.field import ntt
        from zkm_tpu_torch.hash import poseidon as ps
        k1 = getattr(ps, "_permute_cuda", None)
        k2 = getattr(ntt, "_transform_cuda", None)

        def permute(state):
            self.k1_states += state.numel() // roofline.POSEIDON_WIDTH
            return k1(state)

        def transform(x, log_n, inverse, scale, factor):
            rows, n_in = x.shape
            self.k2_int32_ops += roofline.BUTTERFLY_INT32_OPS * \
                roofline.ntt_butterflies(rows, n_in, log_n)
            self.k2_bytes += roofline.ntt_bytes(rows, n_in, log_n,
                                                scale is not None)
            return k2(x, log_n, inverse, scale, factor)

        if k1 is not None:
            ps._permute_cuda = permute
        if k2 is not None:
            ntt._transform_cuda = transform
        try:
            yield self
        finally:
            if k1 is not None:
                ps._permute_cuda = k1
            if k2 is not None:
                ntt._transform_cuda = k2

