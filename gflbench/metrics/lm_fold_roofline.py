"""The client fold's bound (:func:`gflbench.counts.fold_bytes`: the
gradients and the parameters read once, psi written once, over the HBM
rate) over the fold kernels' device time a round (K1 ``norms_*``, K2
``fold_apply_kernel``)."""
from gflbench import counts, peaks

KERNELS = ("norms_rows", "norms_split", "fold_apply_kernel")


def read(run):
    tr, w = run.trace, run.workload
    if tr is None or "servers" not in w or "clients" not in w:
        return None
    seconds = tr.seconds_matching(*KERNELS)
    if seconds <= 0:
        return None
    bound = counts.fold_bytes(w["servers"], w["clients"],
                              run.config["parameters"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound * tr.units / seconds
