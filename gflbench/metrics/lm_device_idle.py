"""Share of the traced window in which no operation ran on the device."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
