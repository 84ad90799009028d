"""Mean over every lockstep decode step of the window of the gap between
successive tokens known on the host."""


def read(run):
    gaps = [g for d in run.rec.decodes for g in d["gaps"]]
    if not gaps:
        raise RuntimeError("no lockstep step in the window: token_gap_ms has nothing to read")
    return 1e3 * sum(gaps) / len(gaps)
