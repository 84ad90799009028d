#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this machine's CUDA card(s).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic file names its driver, ``drivers/<driver>.py``, whose
``run`` builds the weights on the card from the seed, builds the port's
kernels where the checkout has none yet, warms up the cell's shapes,
measures for ``--seconds``, then works out what the window produced again
with the plain reference.  Each metric is read by ``metrics/<name>.py``:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
from a profiled run with ``--trace 1``.  The compared numbers are judged
against ``limits/<cell>.json`` and one JSON line is printed.
``--control 1`` judges the control (the reference at fp8 in the program's
place) instead: its line reads ``correct`` false.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import faulthandler  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness  # noqa: E402

harness.fix_environment()


def main(argv=None, root: Path = harness.CHECKOUT, device: str = "cuda") -> int:
    args = harness.parse_args(argv)
    cell = harness.Cell(args.workload, root=Path(root), here=Path(root) / "portbench")
    if device == "cuda":
        harness.require_cards(cell.chips)
    driver = harness.load_module(cell.here, "drivers", cell.driver)
    run = driver.run(cell, args, T_START, device)
    metrics = harness.read_metrics(run, cell.per_layer if args.trace else cell.end_to_end)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 4
    correct, chk = harness.judge(run, cell.limits, control=bool(args.control))
    for key, v in run.notes.items():
        print(f"portbench: {key} = {v}", file=sys.stderr)
    for what, met in run.sound:
        print(f"portbench: {what}: {'yes' if met else 'NO'}", file=sys.stderr)
    if args.control:
        print(f"portbench: the program's numbers = {json.dumps(run.numbers)}", file=sys.stderr)
        print("portbench: judged: the control (the reference at fp8)", file=sys.stderr)
    harness.print_checks(chk)
    print(harness.result_line(correct, run.attempted, run.failed, metrics, run.device, chk,
                              run.breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    # a run that has not ended by then is refused anyway: end it with every
    # thread's stack on stderr (SIGUSR1 prints them without ending it)
    faulthandler.dump_traceback_later(345, exit=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    code = main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(code)
