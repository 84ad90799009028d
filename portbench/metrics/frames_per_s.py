"""Frames whose ``BatchedSessionBroker.submit`` returned without error in
the window, all streams together, over the window's seconds."""


def read(run):
    return run.out["frames_ok"] / run.window_s
