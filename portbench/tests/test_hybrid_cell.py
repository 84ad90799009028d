"""The hybrid driver (``drivers/hybrid.py``) at a tiny size on the CPU: a
whole run of a tiny Jamba cell through ``run.main``, correct; the control,
not correct; a traced run reads the cell's per-layer metrics without
raising; and a port that reads the config as no hybrid ends the run at once.

    python -m pytest portbench/tests/test_hybrid_cell.py -q
"""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import harness  # noqa: E402
import tiny  # noqa: E402

harness.fix_environment()

CELL = "tiny.ask"
METRICS = ("hybrid.mamba_prefill_ms", "selective_scan_roofline", "hybrid.sink_row_share",
           "mfu.hybrid_prefill", "mfu.hybrid_decode")


def tiny_jamba_config() -> dict:
    cfg = json.loads((HERE.parent / "configs" / "streammind-jamba2-mini-int4.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=8, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=256, num_experts=4, mamba_dt_rank=8,
               attn_layer_period=4, attn_layer_offset=2)
    cfg["streammind"] = copy.deepcopy(tiny.tiny_config()["streammind"])
    return cfg


def hybrid_checkout(tmp: Path) -> Path:
    """A copy of the benchmark holding one tiny hybrid cell and its metrics."""
    root = tmp / "checkout"
    shutil.copytree(HERE.parent, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "configs" / "tiny-jamba.json").write_text(json.dumps(tiny_jamba_config()))
    traffic = dict(tiny.tiny_traffic(True), driver="hybrid")
    (pb / "traffic" / "tinyask.json").write_text(json.dumps(traffic))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        dict(tiny.TINY_LIMITS, hybrid_state_relerr=0.05)))
    bench = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-jamba", "source": "test",
                         "file": "portbench/configs/tiny-jamba.json", "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny-jamba", "traffic": "tinyask", "chips": 1,
                           "why": "test"}]
    bench["end_to_end"] = [dict(m, workloads=[CELL]) for m in bench["end_to_end"]
                           if m["name"] in ("first_token_ms", "token_gap_ms", "setup_s")]
    bench["per_layer"] = [dict(m, workloads=[CELL]) for m in bench["per_layer"]
                          if m["name"] in METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, capsys, seed=2 ** 31 + 77, control=0, trace=0):
    import run

    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "2", "--trace", str(trace),
            "--control", str(control)]
    assert run.main(argv, root=root, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tiny_hybrid_cell_is_correct_and_its_control_is_not(tmp_path, capsys):
    root = hybrid_checkout(tmp_path)
    out = _run(root, capsys)
    assert out["correct"], out["checks"]
    assert {"token_gap", "route_miss", "hybrid_state_relerr"} <= set(out["checks"])
    assert set(out["metrics"]) == {"first_token_ms", "token_gap_ms", "setup_s"}
    assert not harness.forbidden_modules()
    ctl = _run(root, capsys, control=1)
    assert ctl["correct"] is False
    assert [n for n, c in ctl["checks"].items() if c["value"] > c["limit"]], ctl["checks"]


def test_tiny_hybrid_cell_traced(tmp_path, capsys):
    """A traced run on the CPU: the metrics read from the program and the
    host clock come out; those read from the device's trace have nothing
    to read there and are left out."""
    out = _run(hybrid_checkout(tmp_path), capsys, trace=1)
    assert {"hybrid.sink_row_share", "mfu.hybrid_prefill", "mfu.hybrid_decode"} <= set(
        out["metrics"]), out["metrics"]
    assert 0 <= out["metrics"]["hybrid.sink_row_share"]["value"] < 1


def test_a_port_without_the_hybrid_ends_the_run_at_once(tmp_path, capsys, monkeypatch):
    from streammind_torch import config

    monkeypatch.setattr(config, "text_config_from_hf", lambda raw: config.TextConfig())
    with pytest.raises(SystemExit) as e:
        _run(hybrid_checkout(tmp_path), capsys)
    assert e.value.code == 5
