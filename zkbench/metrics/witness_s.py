"""witness_s (s): seconds a segment proof spends generating its witness
(`witness/`): the port's StepTimer step "witness"."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "witness")
