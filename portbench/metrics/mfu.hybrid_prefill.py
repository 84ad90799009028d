"""A hybrid (Jamba) decoder's prefill model operations (``hybrid_flops``)
over the prefills' time (call to first tokens on the host) at the chip's
bfloat16 peak."""
import hybrid_flops


def read(run):
    p = [x for x in run.rec.prefills if "t1" in x]
    secs = sum(x["t1"] - x["t0"] for x in p)
    if not secs:
        return None
    ops = sum(hybrid_flops.prefill(run.hybrid, x) for x in p)
    return 100.0 * ops / (secs * run.peaks.BF16_FLOPS)
