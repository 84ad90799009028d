"""Share of the traced window's MoE layer calls above the decode steps' 4
tokens that took the grouped int4 dispatch: the program's
``moe.grouped_int4`` counter over it plus ``moe.dense`` (calls of the dense
dispatch).  Left out where the program counts neither."""
import program_spans


def read(run):
    _, counts = program_spans.of(run)
    grouped, dense = counts.get("moe.grouped_int4", 0), counts.get("moe.dense", 0)
    return grouped / (grouped + dense) if grouped + dense else None
