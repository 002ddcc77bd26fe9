"""attn_roofline_pct.serve: the least time of the window's K2 launches
over the device time of flash_kernel, in %."""

from port_bench import roofline


def read(r):
    tr = r.get("trace")
    if tr is None:
        return None
    return roofline.share_pct(r["launch_shapes"], roofline.ATTN, tr.kernels,
                              roofline.ATTN_KERNELS)
