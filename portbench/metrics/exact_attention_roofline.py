"""The exact ViT attention's share of its roofline over the traced window:
every launch is the tick's (capacity, patches + 1, heads, head_dim)."""


def read(run):
    k = run.kernel("exact_attention")
    n, seconds = run.trace.kernel(k.NAME)
    if not n or seconds <= 0:
        return None
    v = run.dm.vision
    bound, _ = run.bound(*k.cost(run.cell.traffic["streams"], v.patches + 1, v.heads, v.head_dim))
    return 100.0 * n * bound / seconds
