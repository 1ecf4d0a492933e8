"""Share of the window in which the device is idle, read in a traced run:
one minus the device's busy time a round, from the profiler's trace of
the traced runs, times the rounds of the untraced window before them,
over that window's length.  The window itself runs without the profiler,
whose work on each launch would slow the host's part of a round several
times over and show an idle device that is not."""


def read(run):
    tr, w, rounds = run.trace, run.window, run.workload.get("rounds")
    if tr is None or not tr.ops or not rounds or "rounds" not in w:
        return None
    busy_round_s = tr.busy_s / (tr.units * rounds)
    return 100.0 * (1.0 - busy_round_s * w["rounds"] / w["seconds"])
