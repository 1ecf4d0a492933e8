"""Device operations of the traced runs over their rounds."""


def read(run):
    tr, rounds = run.trace, run.workload.get("rounds")
    if tr is None or not tr.ops or not rounds:
        return None
    return len(tr.ops) / (tr.units * rounds)
