"""Mean time of a batched paged prefill, from the call of
``PagedDialogues._prefill`` to its first tokens on the host."""


def read(run):
    spans = [p["t1"] - p["t0"] for p in run.rec.prefills if "t1" in p]
    return 1e3 * sum(spans) / len(spans) if spans else None
