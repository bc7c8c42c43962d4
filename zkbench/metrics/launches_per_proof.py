"""launches_per_proof (launches): device kernels, copies and sets in the
traced window's trace, per segment proof."""


def read(t):
    if not t.device_events or not t.proofs:
        return None
    return t.device_events / t.proofs
