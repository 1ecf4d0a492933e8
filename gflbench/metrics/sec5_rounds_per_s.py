"""Rounds of the runs completed in the window over the whole window."""


def read(run):
    rounds = run.window.get("rounds")
    if rounds is None:
        return None
    return rounds / run.window["seconds"]
