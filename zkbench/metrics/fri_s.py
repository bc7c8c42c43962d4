"""fri_s (s): seconds a segment proof spends in the openings, FRI and its
proof of work (`fri/`): StepTimer steps "openings", "fri" and "pow"."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "openings", "fri", "pow")
