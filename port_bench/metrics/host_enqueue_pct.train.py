"""host_enqueue_pct.train: the host time of the program's `i2i.train.step`
spans (the paired train step, entry to return) over the spans window's
time, in %. Read from `port_bench/spans.py`'s spans window; None in a run
without one."""

from port_bench import spans


def read(r):
    return spans.host_share_pct(r, "i2i.train.step")
