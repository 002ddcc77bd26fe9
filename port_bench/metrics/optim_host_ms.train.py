"""optim_host_ms.train: host ms a step in the program's `i2i.train.optim`
spans (the AdamW update, once a pass). Read from `port_bench/spans.py`'s
spans window; None in a run without one."""

from port_bench import spans


def read(r):
    return spans.host_ms(r, "i2i.train.optim")
