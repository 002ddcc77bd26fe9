"""conv_roofline_pct.serve: the least time of the window's K1, K4 and K6
launches (port_bench/roofline.py, by the port's launch counter) over the
device time of their kernels (conv_kernel, down_kernel and their split
reductions), in %."""

from port_bench import roofline


def read(r):
    tr = r.get("trace")
    if tr is None:
        return None
    return roofline.share_pct(r["launch_shapes"], roofline.CONV, tr.kernels,
                              roofline.CONV_KERNELS)
