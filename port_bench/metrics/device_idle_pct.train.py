"""device_idle_pct.train: the share of a train step's time in which no
operation ran on the card, in %: 1 - the traced window's device busy time
a step over the untraced window's mean step time, so that the profiler's
host cost stays out of it (trace.untraced_idle_pct)."""

from port_bench import trace


def read(r):
    return trace.untraced_idle_pct(r)
