"""Mean host time of ``MultiStreamServer.step`` on the window's ticks where
no gate fired (the span ends after the gate probs reach the host)."""


def read(run):
    spans = [t1 - t0 for t0, t1, fired in run.rec.tick_spans if not fired]
    return 1e3 * sum(spans) / len(spans) if spans else None
