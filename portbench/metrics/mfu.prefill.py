"""Prefill model operations over the prefills' time (call to first
tokens on the host) at the chip's bfloat16 peak."""


def read(run):
    p = [x for x in run.rec.prefills if "t1" in x]
    secs = sum(x["t1"] - x["t0"] for x in p)
    if not secs:
        return None
    return 100.0 * sum(run.flops.prefill(run.dm.text, x) for x in p) / (secs * run.peaks.BF16_FLOPS)
