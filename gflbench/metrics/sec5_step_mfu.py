"""The round's arithmetic, counted from its shapes
(:func:`gflbench.counts.logistic_round_flops`), over the device busy time
of the traced runs, as a share of the fp32 peak."""
from gflbench import counts, peaks


def read(run):
    tr, c, w = run.trace, run.config, run.workload
    if tr is None or not tr.ops or not w.get("rounds") or "M" not in c:
        return None
    flops = counts.logistic_round_flops(
        c["P"], w["clients_sampled"] or c["K"], c["batch_size"], c["M"])
    rounds = tr.units * w["rounds"]
    return 100.0 * flops * rounds / tr.busy_s / peaks.F32_FLOPS_PER_S
