"""setup_s: seconds from the process's start to the first timed request
or step (kernel build or load, weights from the seed, warm-up)."""


def read(r):
    return r["setup_s"]
