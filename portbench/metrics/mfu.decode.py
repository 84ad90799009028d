"""Decoded tokens' model operations over the decode steps' time (the gaps
between tokens known on the host) at the chip's bfloat16 peak."""


def read(run):
    d = [x for x in run.rec.decodes if "fed" in x]
    secs = sum(sum(x["gaps"]) for x in d)
    if not secs:
        return None
    return 100.0 * sum(run.flops.decode(run.dm.text, x) for x in d) / (secs * run.peaks.BF16_FLOPS)
