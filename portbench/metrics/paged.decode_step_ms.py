"""Mean host time of ``PagedDialogues._decode_step`` over the window's
lockstep steps (Mixtral's reads its expert ids on the host, so the span
holds the step's device work)."""


def read(run):
    spans = [s for d in run.rec.decodes for s in d["step_s"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
