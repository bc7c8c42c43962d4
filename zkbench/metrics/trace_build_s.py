"""trace_build_s (s): seconds a segment proof spends building the
tables' rows (`host.trace_set_traces`, `tables/`): StepTimer step
"trace_build"."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "trace_build")
