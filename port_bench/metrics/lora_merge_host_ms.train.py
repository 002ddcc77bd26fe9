"""lora_merge_host_ms.train: host ms a step in the program's
`i2i.train.lora_merge` spans (`build_gen_params`, once a generator pass).
Read from `port_bench/spans.py`'s spans window; None in a run without
one."""

from port_bench import spans


def read(r):
    return spans.host_ms(r, "i2i.train.lora_merge")
