"""Frames a batched tick carried in the window: the broker's own counters
(``frames_seen / ticks``), read before and after the window."""


def read(run):
    return run.out["frames_seen"] / run.out["ticks"] if run.out.get("ticks") else None
