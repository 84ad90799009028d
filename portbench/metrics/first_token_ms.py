"""Mean over every event of the window of the client's submit of the frame
that fired the gate to that stream's first token on the host."""


def read(run):
    events = run.out["events"]
    if not events:
        raise RuntimeError("no gate fired in the window: first_token_ms has nothing to read")
    return 1e3 * sum(events) / len(events)
