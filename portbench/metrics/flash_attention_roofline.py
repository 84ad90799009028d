"""The flash prefill attention's share of its roofline over the traced
window: one launch a layer of each batched paged prefill recorded there."""


def read(run):
    k = run.kernel("flash_attention")
    t = run.dm.text
    prefills = run.traced(run.rec.prefills)
    n, seconds = run.trace.kernel(k.NAME)
    if not prefills or not n or n != t.layers * len(prefills):
        return run.mismatch("flash_attention", n, t.layers * len(prefills))
    bound = sum(run.bound(*k.cost(p["offsets"], p["bucket"], t.heads, t.kv_heads, t.head_dim))[0]
                for p in prefills)
    return 100.0 * t.layers * bound / seconds
