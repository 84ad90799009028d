"""The selective-scan kernel's share of its roofline over the traced
window: a hybrid decoder's prefill of K rows launches it once a Mamba
layer, over (K, d_inner, bucket) with d_state states; the perception tier
steps its state without it."""


def read(run):
    if run.trace is None:
        return None
    k = run.kernel("selective_scan")
    t = run.hybrid
    layers = t.counts["mamba"]
    prefills = run.traced(run.rec.prefills)
    n, seconds = run.trace.kernel(k.NAME)
    if not prefills or not n or n != layers * len(prefills):
        return run.mismatch("selective_scan", n, layers * len(prefills))
    bound = sum(run.peaks.bound_s(*k.cost(p["k"], t.inner, p["bucket"], t.n),
                                  run.peaks.FP32_FLOPS)[0] for p in prefills)
    return 100.0 * layers * bound / seconds
