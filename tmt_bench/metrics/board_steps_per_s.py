"""Board-steps completed per second: the batch times the steps of the
window, over the window's wall time from the first step to the
synchronisation after the last (host clock).  Draws and auto-resets
count."""


def read(run):
    win = run["window"]
    return win["batch"] * win["steps"] / win["wall_s"]
