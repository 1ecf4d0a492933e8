"""Device busy time of the traced runs over their rounds, microseconds."""


def read(run):
    tr, rounds = run.trace, run.workload.get("rounds")
    if tr is None or not tr.ops or not rounds:
        return None
    return tr.busy_s / (tr.units * rounds) * 1e6
