"""The combine's bound (:func:`gflbench.counts.combine_bytes`: psi, the
noise and A read once, the result written once, over the HBM rate) over
the combine kernel's device time a round (K3 ``combine_kernel``)."""
from gflbench import counts, peaks

KERNELS = ("combine_kernel",)


def read(run):
    tr, servers = run.trace, run.workload.get("servers")
    if tr is None or servers is None:
        return None
    seconds = tr.seconds_matching(*KERNELS)
    if seconds <= 0:
        return None
    bound = counts.combine_bytes(servers,
                                 run.config["parameters"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound * tr.units / seconds
