"""Device time of the kernels under the benchmark's range around the port's
Mamba-layer calls (``models/jamba.py::mamba_mixer``) inside prefills, per
prefill of the traced window."""


def read(run):
    if run.trace is None:
        return None
    prefills = len(run.trace.gpu_ranges.get("portbench.prefill", []))
    _, seconds = run.trace.time_inside("portbench.mamba")
    return 1e3 * seconds / prefills if prefills and seconds > 0 else None
