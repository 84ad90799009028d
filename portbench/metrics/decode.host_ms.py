"""The host's own time in a decode step: mean over the program's traced
``paged.decode_step`` spans of the span's length less what its
``moe.expert_ids`` spans (the host blocked reading expert ids) cover."""
import program_spans


def read(run):
    spans, _ = program_spans.of(run)
    steps = program_spans.named(spans, "paged.decode_step")
    if not steps:
        return None
    step_of = program_spans.enclosing(spans, "paged.decode_step")
    blocked = {r["id"]: 0 for r in steps}
    for r in program_spans.named(spans, "moe.expert_ids"):
        if r["id"] in step_of:
            blocked[step_of[r["id"]]] += r["t1"] - r["t0"]
    return sum(r["t1"] - r["t0"] - blocked[r["id"]] for r in steps) / len(steps) / 1e6
