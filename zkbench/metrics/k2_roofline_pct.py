"""k2_roofline_pct (%): K2, the Goldilocks NTT (`csrc/ntt.cu`), against its
roofline: the least time the transforms handed to it in the window need
(`roofline.ntt_butterflies`, the zero padding's copies left out;
`roofline.ntt_bytes`) over the device time of its two kernels in the
trace."""

from zkbench.readers import roofline_pct

KERNEL = r"(^|[\s:])(first_)?pass_kernel\b"


def read(t):
    return roofline_pct(t, KERNEL, t.k2_int32_ops, t.k2_bytes)
