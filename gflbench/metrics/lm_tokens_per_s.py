"""Client tokens of the rounds completed in the window over the whole
window (the last round's end, on the device, included)."""


def read(run):
    tokens = run.window.get("tokens")
    if tokens is None:
        return None
    return tokens / run.window["seconds"]
