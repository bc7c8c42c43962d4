"""commit_s (s): seconds a segment proof spends committing (`commit/`):
StepTimer steps "trace_commit", "aux_commit" and "quotient_commit"."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "trace_commit", "aux_commit", "quotient_commit")
