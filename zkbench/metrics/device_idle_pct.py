"""device_idle_pct (%): the share of an untraced proof's time in which no
kernel, copy or set runs on the card: 100 - 100 x the device's busy
seconds per proof (the union of the device intervals of the traced
window's trace / its proofs) / the seconds of one untraced proof at the
cell's shapes, timed beside the window.  The traced window itself runs
slower by the profiler's host overhead; its idle share is the driver's
`busy_s` / `window_s`."""


def read(t):
    if not t.busy_s or not t.proofs or not t.untraced_s_per_proof:
        return None
    return 100.0 * (1.0 - t.busy_s / t.proofs / t.untraced_s_per_proof)
