"""k1_roofline_pct (%): K1, the Poseidon permutation (`csrc/poseidon.cu`),
against its roofline: the least time the permutations handed to it in the
window need (`roofline.poseidon_int32_ops` each, 192 bytes each) over the
device time of its kernel in the trace."""

from zkbench import roofline
from zkbench.readers import roofline_pct

KERNEL = r"(^|[\s:])permute_kernel\b"


def read(t):
    return roofline_pct(t, KERNEL, t.k1_states * roofline.poseidon_int32_ops(),
                        t.k1_states * roofline.POSEIDON_BYTES)
