"""quotient_peak_gib (GiB): the most device memory allocated within the
quotient step (`stark/expr.py`'s evaluation over the 2n coset), over every
proof of the window: the peak statistics are reset as the step starts."""


def read(t):
    peak = t.step_peak_bytes.get("quotient")
    return None if peak is None else peak / 2**30
