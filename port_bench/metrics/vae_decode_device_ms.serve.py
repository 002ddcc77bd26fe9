"""vae_decode_device_ms.serve: device ms a traced image of the operations
launched under the program's `i2i.gen.decode` span (the skip-fused VAE
decoder). Read from `port_bench/spans.py`'s attribution of the traced
window; None in a run without it."""

from port_bench import spans


def read(r):
    return spans.device_ms_per_image(r, "i2i.gen.decode")
