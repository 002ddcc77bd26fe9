"""gpu_kernels_per_step: GPU kernels in the traced window's device trace
(copies and fills left out) over the train steps it ran."""


def read(r):
    tr = r.get("trace")
    if tr is None or not tr.kernel_count:
        return None
    return tr.kernel_count / r["traced_count"]
