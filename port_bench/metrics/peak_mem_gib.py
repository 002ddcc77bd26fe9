"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, reset
when it opens; nothing without a card."""


def read(r):
    peak = r.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
