"""Share of the traced part of a match window in which no operation ran on
the device (the host-paced decode steps sit mostly here)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
