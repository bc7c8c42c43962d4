"""The window's arithmetic on a synthetic timeline with a stall, and the
device trace's reduction to busy time and named idle gaps."""

from zkbench import harness, trace
from zkbench.generator import Program


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def prover(clock, durations):
    it = iter(durations)

    def prove(prog, timer=None):
        clock.now += next(it)
        return ["seg"], ["receipt"]
    return prove


def progs(n):
    return [Program(i + 1, b"", ()) for i in range(n)]


def test_window_takes_programs_while_the_last_fits():
    clock = Clock()
    # 4 s, 4 s, then a 10 s stall: after it (18 s) a fourth would not fit
    # in 20 s, after 8 s a third still did (8 + 4 <= 20)
    w = harness.run_window(prover(clock, [4, 4, 10, 1, 1]), progs(5), 20,
                           clock=clock)
    assert (w.attempted, w.proofs, w.seconds) == (3, 3, 18)
    assert 3 * 60 / w.seconds == 10.0


def test_window_runs_one_program_at_least():
    clock = Clock()
    w = harness.run_window(prover(clock, [30, 1]), progs(2), 10, clock=clock)
    assert (w.attempted, w.seconds) == (1, 30)


def test_window_ends_with_its_programs():
    clock = Clock()
    w = harness.run_window(prover(clock, [1, 1]), progs(2), 100, clock=clock)
    assert (w.attempted, w.seconds) == (2, 2)


def test_a_failed_program_counts():
    clock = Clock()

    def prove(prog, timer=None):
        clock.now += 1
        if prog.index == 2:
            raise ValueError("broken")
        return ["seg"], ["receipt"]
    w = harness.run_window(prove, progs(3), 100, clock=clock)
    assert (w.attempted, w.failed, w.proofs) == (3, 1, 2)


def test_trace_busy_union_and_named_gaps():
    t0, t1 = 1000, 2000
    events = [("k1", 900, 1100),      # clipped to [1000, 1100)
              ("k2", 1050, 1200),     # overlaps k1: counted once
              ("k1", 1500, 1600),
              ("copy", 2500, 2600)]   # outside the window
    spans = [("witness", 1200, 1500), ("ctl", 1600, 2000)]
    s = trace.summarize(events, t0, t1, spans)
    assert s["busy_s"] == 300 / 1e9
    assert s["device_events"] == 3 and s["events_outside_window"] == 1
    assert s["kernels"]["k1"] == [2, 200 / 1e9]
    assert s["idle_gaps"] == [["ctl", 400 / 1e9], ["witness", 300 / 1e9]]


def test_sample_is_drawn_from_the_seed():
    traffic = {"check_sample": 2}
    a = harness.sample_of(traffic, 5, 10)
    assert a == harness.sample_of(traffic, 5, 10) and len(a) == 2
    assert harness.sample_of(traffic, 5, 1) == [0]
