"""device_idle_pct.serve: the share of a request's time in which no
operation ran on the card, in %: 1 - the traced window's device busy time
a request over the untraced window's mean request time
(trace.untraced_idle_pct)."""

from port_bench import trace


def read(r):
    return trace.untraced_idle_pct(r)
