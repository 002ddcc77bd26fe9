"""gen_backward_host_ms.train: host ms a step in the program's
`i2i.train.backward` spans under the two generator passes (the
`autograd.grad` call; on a card it waits for the backward's launches).
Read from `port_bench/spans.py`'s spans window; None in a run without
one."""

from port_bench import spans


def read(r):
    return spans.host_ms(r, "i2i.train.backward", spans.GEN_PASSES)
