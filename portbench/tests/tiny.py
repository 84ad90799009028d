"""A tiny StreamMind (and a tiny Mixtral beside it) for the benchmark's CPU
tests: every path of a cell at shapes a test run holds."""
import copy
import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]


def tiny_config(mixtral: bool = False) -> dict:
    cfg = json.loads((PORTBENCH / "configs" / "streammind-7b.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=256)
    sm = cfg["streammind"]
    sm["vision"].update(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=3, num_attention_heads=4)
    sm["mamba"].update(d_model=64, dt_rank=4)
    sm["gate"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    sm["max_stream_frames"] = 64
    if mixtral:
        cfg.update(num_local_experts=4, num_experts_per_tok=2, model_type="mixtral")
        cfg["serving"] = copy.deepcopy(cfg["serving"])
        cfg["serving"]["decoder_int4_pc"] = True
    return cfg


def tiny_traffic(match: bool, streams: int = 3) -> dict:
    t = {"driver": "serve", "why": "tiny", "streams": streams, "page_size": 8,
         "max_wait_ms": 1000, "frame_cycle": 3, "moments": None, "trace_seconds": 2}
    if match:
        t["moments"] = {"gap_frames": [2, 5], "fire_p": 0.5, "max_new_tokens": [3, 6],
                        "prompt_tokens": [4, 9], "clip_frames": [10, 20], "pool": 4}
    return t


def tiny_checkout(tmp: Path) -> Path:
    """A copy of the benchmark with three tiny cells: watch (for
    ``s7b.watch32``), match over a tiny int4 Mixtral (for
    ``mixtral.match4``), and match over the tiny dense decoder."""
    root = tmp / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (pb / "configs" / "tiny-mixtral.json").write_text(json.dumps(tiny_config(True)))
    (pb / "traffic" / "tinywatch.json").write_text(json.dumps(tiny_traffic(False)))
    (pb / "traffic" / "tinymatch.json").write_text(json.dumps(tiny_traffic(True)))
    bench = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"},
                        {"name": "tiny-mixtral", "source": "test",
                         "file": "portbench/configs/tiny-mixtral.json", "reduced": [],
                         "why": "test"}]
    cells = {"tiny.watch": ("tiny", "tinywatch"), "tiny.match": ("tiny", "tinymatch"),
             "tinymix.match": ("tiny-mixtral", "tinymatch")}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t) in cells.items()]
    stand_in = {"s7b.watch32": "tiny.watch", "mixtral.match4": "tinymix.match"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [stand_in[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for n in cells:
        (pb / "limits" / f"{n}.json").write_text(json.dumps(TINY_LIMITS))
    return root


# limits of the tiny cells: far above what bfloat16 against the float32
# reference reads there, far below what the faults read
TINY_LIMITS = {"features_relerr": 0.05, "memory_relerr": 0.05, "state_relerr": 0.05,
               "probs_relerr": 0.05, "token_gap": 0.5, "route_miss": 0.02}
