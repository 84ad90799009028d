"""The benchmark's own tests, on the CPU at tiny sizes:

    python -m pytest portbench/tests -q

Tests marked ``gpu`` need a CUDA card and decide that inside the test."""
from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import flops  # noqa: E402
import harness  # noqa: E402
import peaks  # noqa: E402
import tiny  # noqa: E402
from modelcfg import dims  # noqa: E402

harness.fix_environment()


# -- traffic -----------------------------------------------------------------------------
def _serve():
    return harness.load_module(HERE.parent, "drivers", "serve")


def _schedule(seed, traffic=None):
    traffic = traffic or tiny.tiny_traffic(True, streams=4)
    return _serve().Schedule(traffic, seed, dims(tiny.tiny_config()), "cpu")


def test_schedule_is_the_seeds():
    a, b = _schedule(2 ** 31 + 5), _schedule(2 ** 31 + 5)
    assert a.moments == b.moments
    assert torch.equal(a.frames, b.frames)
    va = [a.viewer_at(s, 0)[0] for s in range(4)]
    vb = [b.viewer_at(s, 0)[0] for s in range(4)]
    assert va == vb
    c = _schedule(2 ** 31 + 6)
    assert not torch.equal(c.frames, a.frames)
    assert c.viewer_at(0, 0)[0]["prompt"] != _schedule(2 ** 31 + 5).viewer_at(0, 0)[0]["prompt"]


def _moments(sched):
    """(gap before it, gates fired, line) of each moment, in order."""
    frames = sorted(sched.moments)
    gaps = np.diff([0] + frames)
    return [(int(g), len(sched.moments[f][0]), sched.moments[f][1]) for g, f in zip(gaps, frames)]


def test_every_seed_does_the_same_work():
    """Every seed gets the same pool of moments (gap, fire count, line) in an
    order of its own; any pool-long run of moments holds the whole pool, and
    the window closes only after such a run."""
    serve = _serve()
    mo = tiny.tiny_traffic(True, streams=4)["moments"]
    n = mo["pool"]
    pool = sorted(serve.moment_pool(mo, 4))
    assert sorted(g for g, _, _ in pool) == serve.value_pool(*mo["gap_frames"], n)
    assert sorted(k for _, k, _ in pool) == sorted(serve.k_pool(4, mo["fire_p"], n))
    orders = []
    for seed in (3, 2 ** 33 + 1, 2 ** 31 + 17):
        sched = _schedule(seed)
        ms = _moments(sched)
        for start in range(3):
            assert sorted(ms[start:start + n]) == pool
        frames = sorted(sched.moments)
        assert [f for f in frames[:3 * n + 1] if sched.closes_cycle(f)] == [
            frames[n], frames[2 * n], frames[3 * n]]
        orders.append(ms[:n])
    assert len({tuple(o) for o in orders}) > 1    # the seed orders the pool
    a, b = _schedule(3), _schedule(2 ** 33 + 1)
    assert a.moments != b.moments
    assert a.viewer_at(0, 0)[0]["prompt"] != b.viewer_at(0, 0)[0]["prompt"]


def test_judged_ticks_span_the_window():
    """The window ticks whose perception is judged are drawn over the whole
    window, not its start."""
    serve = _serve()
    picked = []
    for seed in range(200):
        rec = serve.Recorder(False, np.random.default_rng([seed, 2]))
        rec.capture()           # the run's first tick
        rec.ticks, rec.window = 1, True
        for _ in range(300):
            rec.capture()
            rec.ticks += 1
            rec.window_ticks += 1
        ticks = [c["tick"] for c in rec.captures if c["window"]]
        assert len(ticks) == serve.CHECK_TICKS and len(set(ticks)) == serve.CHECK_TICKS
        assert rec.captures[0] == {"tick": 0, "window": False}
        picked += ticks
    assert min(picked) < 30 and max(picked) > 270
    assert 120 < np.mean(picked) < 180      # uniform over ticks 1..300


def test_k_pool_follows_the_binomial():
    serve = _serve()
    pool = serve.k_pool(4, 0.5, 16)
    assert pool.count(1) == 4 and pool.count(2) == 7 and pool.count(3) == 4 and pool.count(4) == 1
    assert all(k >= 1 for k in serve.k_pool(16, 0.5, 16))
    assert abs(np.mean(serve.k_pool(16, 0.5, 16)) - 8) < 0.6


# -- operation and byte counts -------------------------------------------------------------
def _kernel(name):
    return harness.load_module(HERE.parent, "kernels", name)


def test_kernel_costs_by_hand():
    # exact: B 2, S 3, H 1, D 4: 2 products of 2·3·3·4 MACs each, 2 flops a MAC
    assert _kernel("exact_attention").cost(2, 3, 1, 4) == (2 * 2 * 2 * 3 * 3 * 4, 2 * 4 * 2 * 3 * 4)
    # flash: one row at offset 2, bucket 2: queries see 3 and 4 keys
    f, b = _kernel("flash_attention").cost([2], 2, 1, 1, 4)
    assert f == 2 * 2 * 4 * (3 + 4)
    assert b == 2 * (2 * 2 * 4 + 2 * 4 * 4)
    # paged: one row of 10 keys, page 8: two page ids and a length
    f, b = _kernel("paged_attention").cost([10], 2, 1, 4, 8)
    assert f == 2 * 2 * 2 * 4 * 10
    assert b == 2 * (2 * 10 * 4 + 2 * 2 * 4 + 2 * 4) + 4 * 3
    # int4: B 1, 8 × 16: codes 64 bytes, 8 scales, x 32 bytes, y 16 bytes
    assert _kernel("int4_matvec").cost(1, 8, 16) == (2 * 8 * 16, 64 + 32 + 32 + 16)
    # dK/dV: S 3 causal sees 6 pairs, four products; q, dO (H 2), k, v (Hkv 1) read,
    # lse and delta read, dK and dV written
    f, b = _kernel("flash_bwd_dkv").cost(1, 3, 2, 1, 4)
    assert f == 4 * 2 * 2 * 4 * 6
    assert b == 2 * 3 * 4 * (2 * 2 + 2 * 1) + 2 * 4 * 2 * 3 + 2 * 2 * 3 * 1 * 4


def test_bound_picks_the_larger_time():
    t, by = peaks.bound_s(989e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = peaks.bound_s(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_model_flops_by_hand():
    dm = dims(json.loads((HERE.parent / "configs" / "streammind-7b.json").read_text()))
    # ViT-L/14-336, 23 blocks: ~0.37 TFLOP a frame (the issue's reckoning)
    assert flops.vit_frame(dm.vision) == pytest.approx(0.365e12, rel=0.01)
    t = dm.text
    static = 2 * 32 * (4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336)
    assert flops.tokens(t, 0, 1) == static + 4 * 32 * 4096 + 2 * 4096 * 32000
    # 2 tokens at offset 10 see 11 and 12 keys
    assert flops.tokens(t, 10, 2) == 2 * static + 4 * 32 * 4096 * 23 + 2 * 4096 * 32000
    assert flops.decoded(t, 10, 2) == flops.tokens(t, 10, 2) + 2 * 4096 * 32000
    mx = dims(json.loads((HERE.parent / "configs" / "streammind-mixtral-8x7b-int4.json")
                         .read_text())).text
    moe = 2 * 32 * (2 * 3 * 4096 * 14336 + 4096 * 8)
    assert flops.tokens(mx, 0, 1) - flops.tokens(t, 0, 1) == moe - 2 * 32 * 3 * 4096 * 14336


# -- the reference against the port ---------------------------------------------------------
def _tree_and_cfg(mixtral=False):
    import weights

    cfg = tiny.tiny_config(mixtral)
    tree = weights.build(cfg, 7, "cpu", dtype=torch.float32)
    return tree, cfg, _serve().port_config(cfg), dims(cfg)


def test_reference_perception_matches_the_port():
    from reference import model as ref
    from streammind_torch.models import projector as proj
    from streammind_torch.models.mamba import init_mamba_state
    from streammind_torch.models.vit import vit_forward
    from streammind_torch.utils.quantize import quantize_gate_params

    tree, cfg, pc, dm = _tree_and_cfg()
    pix = torch.randn(3, 3, 28, 28, generator=torch.Generator().manual_seed(1))
    feats = vit_forward(tree["vision"], pc.vision, pix, attn_impl="exact")
    want = ref.vit_features(tree["vision"], dm.vision, pix)
    assert (feats - want).abs().max() < 1e-4
    st = init_mamba_state(pc.mamba, 3, device="cpu")
    st = st._replace(ssm=torch.randn(st.ssm.shape), conv=torch.randn(st.conv.shape))
    params = dict(tree["projector"])
    mem, new = proj.mamba_project_step(params, pc, feats, st)
    rmem, _, rssm = ref.mamba_step(tree["projector"], dm.mamba, feats, st.conv, st.ssm)
    assert (mem - rmem).abs().max() < 1e-4
    assert (new.ssm - rssm).abs().max() < 1e-4
    params["cls_net"] = quantize_gate_params(params["cls_net"], bits=4)
    probs = torch.softmax(proj.gate_decision_step(params, pc, mem), dim=-1)
    rprobs = ref.gate_probs(tree["projector"]["cls_net"], dm.gate, rmem)
    assert (probs - rprobs).abs().max() < 1e-5


@pytest.mark.parametrize("mixtral", [False, True])
def test_reference_decoder_matches_the_port(mixtral):
    from reference import model as ref
    from streammind_torch.models import mistral as lm

    tree, cfg, pc, dm = _tree_and_cfg(mixtral)
    ids = torch.randint(3, 256, (1, 11), generator=torch.Generator().manual_seed(2))
    logits, _ = lm.text_forward(tree["text"], pc.text, input_ids=ids)
    x = tree["text"]["embed_tokens"][ids[0]]
    want = ref.sequence_logits(tree["text"], dm.text, x, torch.arange(11))
    assert (logits[0] - want).abs().max() < 1e-4


def test_reference_rounds_the_int4_gate_as_the_port():
    from reference import model as ref
    from streammind_torch.utils.quantize import (dequantize_linear_weight_int4_pc,
                                                 quantize_linear_weight_int4_pc)

    w = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(3)) * 0.02
    q = quantize_linear_weight_int4_pc(w)
    assert torch.equal(dequantize_linear_weight_int4_pc(q), torch.stack(
        [ref.quantize_int4_pc(w[i]) for i in range(2)]))
    assert torch.equal(ref.dequant_int4_pc(q["w_int4pc"], q["scale"]),
                       dequantize_linear_weight_int4_pc(q))


# -- the last line, the guard, files found by name --------------------------------------------
def test_result_line_shape():
    chk = {"token_gap": {"value": 0.1, "limit": 0.5}}
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "k", "count": 1,
                                "memory_peak_bytes": 5}, chk, {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == chk


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    monkeypatch.setitem(sys.modules, "streammind_torch_x", types.ModuleType("streammind_torch_x"))
    assert harness.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "streammind_tpu.ops", types.ModuleType("streammind_tpu.ops"))
    assert "streammind_tpu" in harness.forbidden_modules()


def test_no_result_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the port is missing, so
    the run stops with another code than 0 and prints no result."""
    import shutil

    shutil.copytree(HERE.parent, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "s7b.watch32", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_new_files_are_found_by_name(tmp_path):
    """A config, a traffic mix and a metric added as files of their own, with
    an entry in a copy of BENCHMARK.json, are what the harness loads."""
    root = tiny.tiny_checkout(tmp_path)
    pb = root / "portbench"
    (pb / "traffic" / "dummymix.json").write_text(json.dumps(tiny.tiny_traffic(False, 2)))
    (pb / "metrics" / "dummy.metric.py").write_text("def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.dummy", "config": "tiny", "traffic": "dummymix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "broker",
                               "moves": "frames_per_s", "workloads": ["tiny.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell("tiny.dummy", root=root, here=pb)
    assert cell.traffic["streams"] == 2 and cell.config["hidden_size"] == 64
    assert cell.driver == "serve"
    assert "dummy.metric" in [m["name"] for m in cell.per_layer]
    assert harness.load_module(pb, "metrics", "dummy.metric").read(None) == 42.0


DUMMY_DRIVER = '''
import harness


def run(cell, args, t_start, device):
    rec = harness.RunRecord(cell)
    rec.setup_s, rec.window_s = 0.5, float(args.seconds)
    rec.out = {"done": 3 * cell.traffic["rate"]}
    rec.attempted = 3
    rec.numbers = {"answer_gap": 0.001}
    if args.control:
        rec.control = {"answer_gap": 1.0}
    rec.sound = [("every answer came", True)]
    rec.device = {"platform": device, "kind": device, "count": 1, "memory_peak_bytes": 0}
    return rec
'''


def test_a_new_kind_of_cell_runs_from_new_files(tmp_path, capsys):
    """A driver, a traffic mix naming it, an end-to-end metric and the cell's
    limits, each a new file, and entries in BENCHMARK.json: the harness runs
    the cell and judges it with no edit to a file it has."""
    import run

    root = tiny.tiny_checkout(tmp_path)
    pb = root / "portbench"
    (pb / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (pb / "traffic" / "dummymix.json").write_text(json.dumps({"driver": "dummy", "rate": 7}))
    (pb / "metrics" / "done_per_s.py").write_text(
        "def read(run):\n    return run.out['done'] / run.window_s\n")
    (pb / "limits" / "tiny.dummy.json").write_text(json.dumps({"answer_gap": 0.01}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.dummy", "config": "tiny", "traffic": "dummymix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "done_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["tiny.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for control, correct in ((0, True), (1, False)):
        argv = ["--workload", "tiny.dummy", "--seed", "5", "--seconds", "3", "--trace", "0",
                "--control", str(control)]
        assert run.main(argv, root=root, device="cpu") == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["correct"] is correct
        assert out["metrics"] == {"done_per_s": {"value": 7.0, "unit": "1/s"},
                                  "setup_s": {"value": 0.5, "unit": "s"}}
        assert out["checks"]["answer_gap"]["limit"] == 0.01


# -- whole tiny runs: sound, the control, and each fault --------------------------------------
def _run(tmp_path, capsys, name, seed=2 ** 31 + 99, control=0):
    """A whole run of a tiny cell through ``run.main`` on the CPU (the look
    for a card skipped): its last line."""
    import run

    root = tiny.tiny_checkout(tmp_path)
    argv = ["--workload", name, "--seed", str(seed), "--seconds", "2", "--trace", "0",
            "--control", str(control)]
    assert run.main(argv, root=root, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["tiny.watch", "tiny.match", "tinymix.match"])
def test_tiny_cell_is_correct(tmp_path, capsys, name):
    out = _run(tmp_path, capsys, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in harness.Cell(
        name, root=tmp_path / "checkout", here=tmp_path / "checkout" / "portbench").end_to_end}
    if "match" in name:
        assert "token_gap" in out["checks"]
    assert not harness.forbidden_modules()   # the run loaded no JAX


def test_control_fails_the_tiny_limits(tmp_path, capsys):
    """The reference at fp8 in the program's place, judged as the program
    is, comes out not correct."""
    out = _run(tmp_path, capsys, "tinymix.match", control=1)
    assert out["correct"] is False
    assert [n for n, c in out["checks"].items() if c["value"] > c["limit"]], out["checks"]


def _fault_state_unchanged(monkeypatch):
    from streammind_torch.models import projector

    step = projector.video_mamba_step
    monkeypatch.setattr(projector, "video_mamba_step",
                        lambda p, c, x, state: (step(p, c, x, state)[0], state))


def _fault_half_batch(monkeypatch):
    from streammind_torch.streaming import engine

    vit = engine.vit_forward

    def half(params, cfg, pixels, **kw):
        n = pixels.shape[0] // 2 or 1
        out = vit(params, cfg, pixels[:n], **kw)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand(pixels.shape[0] - n,
                                                                    *out.shape[1:])])

    monkeypatch.setattr(engine, "vit_forward", half)


def _fault_token_altered(monkeypatch):
    from streammind_torch.streaming import engine

    sample = engine.sample_token_rows
    monkeypatch.setattr(engine, "sample_token_rows",
                        lambda *a: [(t + 1) % 256 for t in sample(*a)])


@pytest.mark.parametrize("fault,cell,number", [
    (_fault_state_unchanged, "tiny.watch", "state_relerr"),
    (_fault_half_batch, "tiny.watch", "features_relerr"),
    (_fault_token_altered, "tiny.match", "token_gap"),
])
def test_fault_makes_correct_false(tmp_path, capsys, monkeypatch, fault, cell, number):
    fault(monkeypatch)
    out = _run(tmp_path, capsys, cell)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]


# -- on the card: the control at the cell's own size ---------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["s7b.watch32", "mixtral.match4"])
def test_control_fails_a_limit_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                            str(seed), "--seconds", "10", "--control", "1"],
                           cwd=HERE.parent.parent, capture_output=True, text=True, timeout=400)
        assert p.returncode == 0, p.stderr[-3000:]
        sys.stderr.write(p.stderr[-1500:])     # the control's numbers beside their limits
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] is False, out["checks"]
