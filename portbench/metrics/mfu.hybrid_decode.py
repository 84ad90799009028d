"""A hybrid (Jamba) decoder's decoded tokens' model operations
(``hybrid_flops``) over the decode steps' time (the gaps between tokens
known on the host) at the chip's bfloat16 peak."""
import hybrid_flops


def read(run):
    d = [x for x in run.rec.decodes if "fed" in x]
    secs = sum(sum(x["gaps"]) for x in d)
    if not secs:
        return None
    ops = sum(hybrid_flops.decode(run.hybrid, x) for x in d)
    return 100.0 * ops / (secs * run.peaks.BF16_FLOPS)
