"""train_mfu_pct: the window's model FLOPs of its paired steps
(port_bench/flops.py) over the window's seconds times the card's bf16
peak, in %."""

from port_bench.roofline import PEAK_BF16_FLOPS


def read(r):
    if r["device"].type != "cuda":
        return None
    return 100.0 * r["flops"] / (r["window_s"] * PEAK_BF16_FLOPS)
