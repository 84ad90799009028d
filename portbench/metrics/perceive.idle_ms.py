"""Device idle a traced tick while the host was inside the program's
``engine.perceive`` span (the ViT, the Mamba step, the gate, the ring
write): the gaps between device work whose middle lies there, over the
traced ``server.step`` spans."""
import program_spans


def read(run):
    spans, _ = program_spans.of(run)
    ticks = len(program_spans.named(spans, "server.step"))
    idle = program_spans.idle_by_span(run)
    if not ticks or not idle:
        return None
    inside = program_spans.enclosing(spans, "engine.perceive")
    return sum(ns for sid, ns in idle.items() if sid in inside) / ticks / 1e6
