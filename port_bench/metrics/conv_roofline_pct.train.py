"""conv_roofline_pct.train: the least time of the window's K1, K4, K6 and
K8-du launches (port_bench/roofline.py, by the port's launch counter) over
the device time of their kernels, in %."""

from port_bench import roofline


def read(r):
    tr = r.get("trace")
    if tr is None:
        return None
    return roofline.share_pct(r["launch_shapes"], roofline.CONV_TRAIN,
                              tr.kernels, roofline.CONV_TRAIN_KERNELS)
