"""Share of the lockstep's row-steps spent on rows that had finished: the
program's ``paged.sink_rows`` counter (a hybrid's finished rows step the
sink state slot) over K × steps of its traced ``paged.decode`` spans."""
import program_spans


def read(run):
    spans, counts = program_spans.of(run)
    rows = sum(r["attrs"].get("K", 0) * r["attrs"].get("steps", 0)
               for r in program_spans.named(spans, "paged.decode"))
    if not rows or "paged.sink_rows" not in counts:
        return None
    return counts["paged.sink_rows"] / rows
