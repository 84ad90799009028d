"""The paged decode attention's share of its roofline over the traced
window: one launch a layer a lockstep step, each row over its length."""


def read(run):
    k = run.kernel("paged_attention")
    t = run.dm.text
    decodes = run.traced(run.rec.decodes)
    steps = sum(d["steps"] for d in decodes)
    n, seconds = run.trace.kernel(k.NAME)
    if not steps or n != t.layers * steps:
        return run.mismatch("paged_attention", n, t.layers * steps)
    page = run.cell.traffic["page_size"]
    bound = 0.0
    for d in decodes:
        for j in range(d["steps"]):
            lengths = [o + min(j, f) + 1 for o, f in zip(d["offsets"], d["fed"])]
            bound += run.bound(*k.cost(lengths, t.heads, t.kv_heads, t.head_dim, page))[0]
    return 100.0 * t.layers * bound / seconds
