"""The window's model operations (every frame's ViT, Mamba step and gate;
every prefilled and decoded token, routed experts only) over the window's
seconds at the chip's bfloat16 peak."""


def read(run):
    f = run.flops
    ops = run.out["frames_ok"] * f.frame(run.dm)
    ops += sum(f.prefill(run.dm.text, p) for p in run.rec.prefills)
    ops += sum(f.decode(run.dm.text, d) for d in run.rec.decodes if "fed" in d)
    return 100.0 * ops / (run.out["window_s"] * run.peaks.BF16_FLOPS)
