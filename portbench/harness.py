"""Plumbing shared by every cell of the port's benchmark.

The command line, the card, the caches inside the checkout, the import
guard, the cell's files found by name (``configs/<config>.json``,
``traffic/<mix>.json``, the driver ``drivers/<driver>.py`` its traffic
names, ``limits/<cell>.json``, ``metrics/<metric>.py`` for every metric,
end-to-end or per-layer, ``kernels/<kernel>.py``), the record a run hands
on, the judgement, and the last line of a run.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / ".portbench_cache"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "streammind_tpu")


def fix_environment() -> None:
    """Every cache a run may write goes to a fixed directory of the checkout,
    and libraries that would load JAX by themselves are told not to."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"
    # one process, few threads: the host-paced paths do not share the
    # machine's cores with idle OpenMP and MKL pools
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference at fp8 in the program's place) "
                         "instead of the program: its result line reads correct false")
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names (before the first dot, compared whole) of the loaded
    modules that belong to JAX or to the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, name: str, root: Path = CHECKOUT, here: Path = HERE):
        self.here = here
        bench = read_json(root / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
        self.name = name
        self.workload = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(here / "traffic" / f"{self.workload['traffic']}.json")
        self.driver = self.traffic["driver"]   # drivers/<driver>.py runs the cell
        limits = here / "limits" / f"{name}.json"
        self.limits = read_json(limits) if limits.exists() else {}
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _in_cell(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _in_cell(m, name)]


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(here: Path, kind: str, name: str):
    """``<here>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_state() -> str:
    """``name, power.limit, clocks.sm, clocks.max.sm`` of the card as
    nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {n} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        raise SystemExit(3)


class RunRecord:
    """What a run hands on.  The driver fills it in; the metric readers
    (``metrics/<name>.py``, each a ``read(run)``) take from it what they
    need; ``judge`` decides ``correct`` from it."""

    def __init__(self, cell):
        import flops
        import peaks

        self.cell, self.here = cell, cell.here
        self.flops, self.peaks = flops, peaks
        self.setup_s = self.window_s = None
        self.out, self.trace = {}, None
        self.attempted = self.failed = 0
        self.numbers = {}        # the program's compared numbers, by name
        self.control = None      # the control's, where it was read
        self.sound = []          # (what, met): what a correct run has besides its limits
        self.notes = {}          # printed on stderr before the checks
        self.device = {}
        self.breakdown = None

    def kernel(self, name: str):
        return load_module(self.here, "kernels", name)

    def bound(self, flops: float, nbytes: float):
        return self.peaks.bound_s(flops, nbytes)

    def traced(self, records: list) -> list:
        """Records of work that began inside the traced part of the window."""
        end = self.out["trace_window"][1] if "trace_window" in self.out else None
        return [r for r in records if end is not None and r["t0"] < end]

    def mismatch(self, kernel: str, got: int, want: int):
        if got != want:
            print(f"portbench: {kernel}: {got} launches in the trace, the recorded work makes "
                  f"{want}; its roofline is left out", file=sys.stderr)
        return None


def read_metrics(run: RunRecord, metrics: list) -> dict:
    """Each metric from its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        v = load_module(run.here, "metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(run: RunRecord, limits: dict, control: bool = False):
    """(correct, checks): every compared number (the control's, with
    ``control``) at or under its limit, and every condition of a sound run
    met."""
    numbers = (run.control or {}) if control else run.numbers
    chk = {n: {"value": float(v), "limit": limits.get(n)} for n, v in numbers.items()}
    correct = (bool(chk) and all(met for _, met in run.sound)
               and all(c["limit"] is not None and c["value"] <= c["limit"] for c in chk.values()))
    return correct, chk


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} ({'ok' if ok else 'FAILED'})",
              file=sys.stderr)
    sys.stderr.flush()


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
