"""emulate_s (s): seconds a segment proof spends in the emulator
(`emulator/`): the benchmark's span around loading a program into a
`State` and `split_prog_into_segs`."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "emulate")
