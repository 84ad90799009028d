"""Share of the decode steps that replayed a CUDA graph: the program's
``paged.graph_replays`` counter over its traced ``paged.decode_step``
spans (the first step of each row count runs eagerly and is captured;
every later one replays)."""
import program_spans


def read(run):
    spans, counts = program_spans.of(run)
    steps = len(program_spans.named(spans, "paged.decode_step"))
    if not steps or "paged.graph_replays" not in counts:
        return None
    return counts["paged.graph_replays"] / steps
