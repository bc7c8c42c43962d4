"""ctl_s (s): seconds a segment proof spends on the cross-table lookups'
and lookups' auxiliary columns (`stark/cross_table_lookup.py`,
`stark/lookup.py`): StepTimer step "ctl"."""

from zkbench.readers import per_proof


def read(t):
    return per_proof(t, "ctl")
