"""The int4 matvec's share of its roofline over the decode steps of the
traced window (Mixtral at int4): a layer of a step of K rows launches it
for the fused q/k/v and o at K rows, and for each row's k experts' gate,
up and down at one row."""


def read(run):
    k = run.kernel("int4_matvec")
    t = run.dm.text
    decodes = run.traced(run.rec.decodes)
    want = sum(t.layers * (2 + 3 * t.top_k * d["k"]) * d["steps"] for d in decodes)
    n, seconds = run.trace.kernel(k.NAME, inside="portbench.decode_step")
    if not want or n != want:
        return run.mismatch("int4_matvec", n, want)
    bound = 0.0
    for d in decodes:
        b = d["k"]
        step = (run.bound(*k.cost(b, t.q_dim + 2 * t.kv_dim, t.d))[0]
                + run.bound(*k.cost(b, t.d, t.q_dim))[0]
                + b * t.top_k * (2 * run.bound(*k.cost(1, t.ffn, t.d))[0]
                                 + run.bound(*k.cost(1, t.d, t.ffn))[0]))
        bound += t.layers * step * d["steps"]
    return 100.0 * bound / seconds
