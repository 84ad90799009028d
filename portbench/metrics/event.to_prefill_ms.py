"""Mean over every fired turn of the traced window of its tick's
``server.step`` start to its ``paged.prefill`` start, joined by event id
(the tick number); a batched prefill of K rows counts K turns."""
import program_spans


def read(run):
    spans, _ = program_spans.of(run)
    ticks = {r["event"]: r["t0"] for r in program_spans.named(spans, "server.step")}
    total = turns = 0
    for r in program_spans.named(spans, "paged.prefill"):
        if r["event"] in ticks:
            k = r["attrs"].get("K", 1)
            total += k * (r["t0"] - ticks[r["event"]])
            turns += k
    return total / turns / 1e6 if turns else None
