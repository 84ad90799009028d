"""Expert-id reads on the host a decode step: the program's
``moe.expert_id_reads`` counter over its traced ``paged.decode_step``
spans (the gathered dispatch reads ``topi`` once a layer)."""
import program_spans


def read(run):
    spans, counts = program_spans.of(run)
    steps = len(program_spans.named(spans, "paged.decode_step"))
    if not steps or "moe.expert_id_reads" not in counts:
        return None
    return counts["moe.expert_id_reads"] / steps
