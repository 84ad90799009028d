"""The port's checkpoint conversion against the JAX package's.

Synthetic HF state dicts (transformers' own Mistral and CLIP builders, and
the released key names from ``streammind_tpu.utils.manifest`` at tiny
widths) go through both packages' converters; every leaf must be bitwise
equal at fp32 and at bf16, stored as fp32 or as bf16.  Also: the three
checkpoint layouts (full SFT, base + mm_projector.bin, LoRA), the trainer
artifact skip list, the port's own safetensors reader against the
safetensors package, the mm_projector.bin export against the released
manifest, model_init from a checkpoint directory, and the other projector
types' state dicts through the dispatch.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.utils import checkpoint as tckpt
from streammind_torch.utils import convert as tconv
from streammind_torch.utils.from_jax import array_to_tensor
from streammind_tpu import api as japi
from streammind_tpu.config import TextConfig, VisionConfig, tiny_streammind_config
from streammind_tpu.utils import convert as jconv

transformers = pytest.importorskip("transformers")
from streammind_tpu.utils.manifest import (  # noqa: E402  (needs transformers)
    clip_vision_manifest,
    mistral_lm_manifest,
    projector_manifest,
)

DATA = os.path.join(os.path.dirname(__file__), "data")
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _assert_trees_bitwise(t_tree, j_tree, path="params"):
    if isinstance(j_tree, dict):
        assert isinstance(t_tree, dict) and set(t_tree) == set(j_tree), path
        for k in j_tree:
            _assert_trees_bitwise(t_tree[k], j_tree[k], f"{path}.{k}")
    elif isinstance(j_tree, (list, tuple)):
        assert len(t_tree) == len(j_tree), path
        for i, (a, b) in enumerate(zip(t_tree, j_tree)):
            _assert_trees_bitwise(a, b, f"{path}.{i}")
    else:
        want = array_to_tensor(np.asarray(j_tree))
        assert t_tree.dtype == want.dtype and t_tree.shape == want.shape, path
        assert torch.equal(t_tree.view(torch.int16) if t_tree.dtype == torch.bfloat16 else t_tree,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want), path


def _sd_torch(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _sd_numpy(sd):
    return {k: v.float().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def hf_mistral_sd():
    conf = transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=256)
    torch.manual_seed(0)
    cfg = TextConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=16)
    return _sd_torch(transformers.MistralForCausalLM(conf)), cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stored", [torch.float32, torch.bfloat16])
def test_convert_hf_text_bitwise(hf_mistral_sd, dtype, stored):
    sd, cfg = hf_mistral_sd
    sd = {k: v.to(stored) for k, v in sd.items()}
    j = jconv.convert_hf_text(_sd_numpy(sd), cfg, JAX_DTYPE[dtype])
    t = tconv.convert_hf_text(sd, tconfig.TextConfig(**dataclasses.asdict(cfg)), dtype)
    _assert_trees_bitwise(t, j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convert_clip_vision_bitwise(dtype):
    conf = transformers.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=3, num_attention_heads=4,
                                         image_size=56, patch_size=14)
    torch.manual_seed(1)
    sd = _sd_torch(transformers.CLIPVisionModel(conf))
    cfg = VisionConfig(image_size=56, patch_size=14, hidden_size=32, intermediate_size=64,
                       num_layers=3, num_heads=4)
    j = jconv.convert_clip_vision(_sd_numpy(sd), cfg, JAX_DTYPE[dtype])
    t = tconv.convert_clip_vision(sd, tconfig.VisionConfig(**dataclasses.asdict(cfg)), dtype)
    _assert_trees_bitwise(t, j)


def _tiny_manifest(cfg, vision=True):
    """The released full-SFT key names at the tiny config's widths."""
    t, g = cfg.text, cfg.gate
    out = dict(mistral_lm_manifest(
        hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
        num_layers=t.num_layers, num_heads=t.num_heads, num_kv_heads=t.num_kv_heads,
        vocab_size=t.vocab_size, head_dim=t.head_dim))
    out.update({"model.mm_projector." + k: v for k, v in projector_manifest(
        mm_hidden_size=cfg.mm_hidden_size, hidden_size=t.hidden_size, n_ssm=cfg.mamba.n_layers,
        d_state=cfg.mamba.d_state, d_conv=cfg.mamba.d_conv, expand=cfg.mamba.expand,
        gate_layers=g.num_layers, gate_vocab=g.vocab_size, gate_hidden=g.hidden_size,
        gate_intermediate=g.intermediate_size, gate_heads=g.num_heads,
        gate_kv_heads=g.num_kv_heads).items()})
    if vision:
        v = cfg.vision
        out.update({"model.vision_tower.vision_tower." + k: s for k, s in clip_vision_manifest(
            hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_layers=v.num_layers, num_heads=v.num_heads, image_size=v.image_size,
            patch_size=v.patch_size).items()})
    return out


def _synth_sd(manifest, seed, dtype=torch.float32):
    """Seeded values of a sane scale for each key: norms near 1, A_log the
    S4D-real init, D ones, the rest N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in sorted(manifest.items()):
        if k.endswith("A_log"):
            a = np.log(np.broadcast_to(np.arange(1, shape[-1] + 1, dtype=np.float32), shape))
        elif k.endswith(".D"):
            a = np.ones(shape, np.float32)
        elif "norm" in k and k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
    return sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convert_projector_bitwise(dtype):
    cfg = tiny_streammind_config()
    sd = {k[len("model.mm_projector."):]: v
          for k, v in _synth_sd(_tiny_manifest(cfg, vision=False), 3).items()
          if k.startswith("model.mm_projector.")}
    j = jconv.convert_projector(_sd_numpy(sd), cfg, JAX_DTYPE[dtype])
    t = tconv.convert_projector(sd, tconfig.tiny_streammind_config(), dtype)
    _assert_trees_bitwise(t, j)
    assert t["mamba"]["blocks"][0]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stored", [torch.float32, torch.bfloat16])
def test_full_sft_checkpoint_bitwise(tmp_path, dtype, stored):
    cfg = tiny_streammind_config()
    sd = _synth_sd(_tiny_manifest(cfg), 4, stored)
    torch.save(dict(list(sd.items())[: len(sd) // 2]), tmp_path / "pytorch_model-00001.bin")
    torch.save(dict(list(sd.items())[len(sd) // 2:]), tmp_path / "pytorch_model-00002.bin")
    j = jconv.convert_streammind_checkpoint(str(tmp_path), cfg, JAX_DTYPE[dtype])
    t = tconv.convert_streammind_checkpoint(str(tmp_path), tconfig.tiny_streammind_config(),
                                            dtype)
    assert set(t) == {"text", "projector", "vision"}
    _assert_trees_bitwise(t, j)


def test_base_plus_mm_projector_bin_bitwise(tmp_path):
    cfg = tiny_streammind_config()
    sd = _synth_sd(_tiny_manifest(cfg, vision=False), 5)
    base, adapter = tmp_path / "base", tmp_path / "adapter"
    base.mkdir()
    adapter.mkdir()
    torch.save({k: v for k, v in sd.items() if not k.startswith("model.mm_projector.")},
               base / "pytorch_model.bin")
    torch.save({k: v for k, v in sd.items() if k.startswith("model.mm_projector.")},
               adapter / "mm_projector.bin")
    j = jconv.convert_streammind_checkpoint(str(adapter), cfg, base_path=str(base))
    t = tconv.convert_streammind_checkpoint(str(adapter), tconfig.tiny_streammind_config(),
                                            base_path=str(base))
    assert set(t) == {"text", "projector"}
    _assert_trees_bitwise(t, j)


def test_merge_lora_bitwise():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((8, 8)).astype(np.float32)
    A = rng.standard_normal((2, 8)).astype(np.float32)
    B = rng.standard_normal((8, 2)).astype(np.float32)
    key = "model.layers.0.self_attn.q_proj"
    lora = {f"base_model.model.{key}.lora_A.weight": A, f"base_model.model.{key}.lora_B.weight": B,
            "base_model.model.model.layers.1.mlp.up_proj.lora_A.default.weight": A}  # unpaired
    for kw in (dict(scaling=0.5), dict(alpha=8.0, r=2), dict()):
        j = jconv.merge_lora({key + ".weight": W}, lora, **kw)
        t = tconv.merge_lora({key + ".weight": torch.from_numpy(W)},
                             {k: torch.from_numpy(v) for k, v in lora.items()}, **kw)
        assert set(t) == set(j)
        np.testing.assert_array_equal(t[key + ".weight"].numpy(), j[key + ".weight"])


def test_lora_checkpoint_layout_bitwise(tmp_path):
    cfg = tiny_streammind_config()
    t = cfg.text
    base_dir, lora_dir = tmp_path / "base", tmp_path / "lora"
    base_dir.mkdir()
    lora_dir.mkdir()
    full = _synth_sd(_tiny_manifest(cfg, vision=False), 6)
    torch.save({k: v for k, v in full.items() if not k.startswith("model.mm_projector.")},
               base_dir / "pytorch_model.bin")
    rng = np.random.default_rng(7)
    r, alpha = 4, 8
    qw = "model.layers.0.self_attn.q_proj"
    A = torch.from_numpy(rng.standard_normal((r, t.hidden_size)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((t.num_heads * t.head_dim, r)).astype(np.float32))
    torch.save({f"base_model.model.{qw}.lora_A.weight": A,
                f"base_model.model.{qw}.lora_B.weight": B}, lora_dir / "adapter_model.bin")
    with open(lora_dir / "adapter_config.json", "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    torch.save({"base_model.model." + k: v for k, v in full.items()
                if k.startswith("model.mm_projector.")}, lora_dir / "non_lora_trainables.bin")

    j = jconv.convert_streammind_checkpoint(str(lora_dir), cfg, base_path=str(base_dir))
    tt = tconv.convert_streammind_checkpoint(str(lora_dir), tconfig.tiny_streammind_config(),
                                             base_path=str(base_dir))
    _assert_trees_bitwise(tt, j)
    expect = full[qw + ".weight"].numpy() + (alpha / r) * (B.numpy() @ A.numpy())
    np.testing.assert_array_equal(tt["text"]["layers"]["q"]["weight"][0].numpy(), expect)
    np.testing.assert_array_equal(tt["projector"]["pre_net"]["weight"].numpy(),
                                  full["model.mm_projector.pre_net.fc3.weight"].numpy())


def test_lora_checkpoint_without_base_raises(tmp_path):
    torch.save({"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
                torch.zeros(4, 64)}, tmp_path / "adapter_model.bin")
    with pytest.raises(ValueError, match="base_path / model_base"):
        tconv.convert_streammind_checkpoint(str(tmp_path), tconfig.tiny_streammind_config())


def test_load_state_dict_skips_trainer_artifacts(tmp_path):
    torch.save({"w": torch.ones(2, 2)}, tmp_path / "pytorch_model.bin")
    torch.save({"not": "weights"}, tmp_path / "training_args.bin")
    for name in ("optimizer.bin", "scheduler.bin", "rng_state_0.bin", "scaler.bin"):
        torch.save({"bogus": 1}, tmp_path / name)
    sd = tconv.load_state_dict(str(tmp_path))
    assert set(sd) == {"w"} and set(jconv.load_state_dict(str(tmp_path))) == {"w"}


def test_safetensors_reader_matches_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g),
        "bf16": torch.randn((4, 2, 3), generator=g).to(torch.bfloat16),
        "f16": torch.randn((7,), generator=g).to(torch.float16),
        "f64": torch.randn((2, 2), generator=g).double(),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(-3, 3, dtype=torch.int32),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "model.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    ours, theirs = tconv.read_safetensors(path), st.load_file(path)
    assert set(ours) == set(theirs) == set(tensors)
    for k in tensors:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        assert ours[k].view(torch.uint8).tolist() == theirs[k].view(torch.uint8).tolist() if \
            ours[k].dim() else torch.equal(ours[k], theirs[k]), k
    # a directory of .safetensors shards loads like .bin shards
    os.remove(path)
    st.save_file({"a": tensors["f32"]}, str(tmp_path / "model-00001.safetensors"))
    st.save_file({"b": tensors["bf16"]}, str(tmp_path / "model-00002.safetensors"))
    sd = tconv.load_state_dict(str(tmp_path))
    assert set(sd) == {"a", "b"} and torch.equal(sd["b"], tensors["bf16"])


def test_projector_export_keys_match_released_manifest(tmp_path):
    """export_projector_torch_sd at the released layer counts (1 SSM layer, a
    4-layer gate) and tiny widths: its keys are the released mm_projector.bin
    keys, its shapes the generator's at those widths, and it converts back
    bitwise."""
    base = tconfig.tiny_streammind_config()
    cfg = base.replace(gate=dataclasses.replace(base.gate, num_layers=4))
    from streammind_torch.models.meta import init_projector

    proj = init_projector(torch.Generator().manual_seed(0), cfg, device="cpu")
    sd = tckpt.export_projector_torch_sd(proj)
    with open(os.path.join(DATA, "checkpoint_manifest_mm_projector_7b.json")) as f:
        released = json.load(f)
    assert {"model.mm_projector." + k for k in sd} == set(released)
    widths = projector_manifest(
        mm_hidden_size=cfg.mm_hidden_size, hidden_size=cfg.text.hidden_size, n_ssm=1,
        d_state=cfg.mamba.d_state, d_conv=cfg.mamba.d_conv, expand=cfg.mamba.expand,
        gate_layers=4, gate_vocab=2, gate_hidden=cfg.gate.hidden_size,
        gate_intermediate=cfg.gate.intermediate_size, gate_heads=cfg.gate.num_heads,
        gate_kv_heads=cfg.gate.num_kv_heads)
    assert {k: list(v.shape) for k, v in sd.items()} == widths

    path = str(tmp_path / "mm_projector.bin")
    tckpt.save_mm_projector_bin(proj, path)
    loaded = torch.load(path, weights_only=True)
    assert set(loaded) == set(sd)
    back = tconv.convert_projector(loaded, cfg)
    for (k, a), (k2, b) in zip(sorted(_flat(back).items()), sorted(_flat(proj).items())):
        assert k == k2 and torch.equal(a, b), k


def _flat(tree, prefix=""):
    from streammind_torch.utils.params import flatten_with_paths

    return dict(flatten_with_paths(tree, prefix))


def test_unported_configs_raise_before_converting(tmp_path):
    """Qwen2 and Mixtral decoders, once refused here, convert: transformers'
    Qwen2ForCausalLM and MixtralForCausalLM state dicts (q/k/v biases; the
    block_sparse_moe router and w1/w3/w2 experts) bitwise as the JAX
    package converts them, at fp32 and bf16, and a Mixtral full-SFT
    checkpoint directory through convert_streammind_checkpoint."""
    base = tconfig.tiny_streammind_config()
    small = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2)
    torch.manual_seed(2)
    models = {"qwen2": transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **small, tie_word_embeddings=False)),
        "mixtral": transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **small, num_local_experts=4, num_experts_per_tok=2))}
    for model_type, model in models.items():
        sd = _sd_torch(model)
        cfg = tconfig.text_config_from_hf(dict(small, model_type=model_type,
                                               num_local_experts=4 if model_type == "mixtral"
                                               else 1))
        jcfg = TextConfig(**dataclasses.asdict(cfg))
        for dtype in (torch.float32, torch.bfloat16):
            _assert_trees_bitwise(tconv.convert_hf_text(sd, cfg, dtype),
                                  jconv.convert_hf_text(_sd_numpy(sd), jcfg, JAX_DTYPE[dtype]))
        if model_type == "mixtral":
            full = base.replace(text=cfg)
            torch.save(sd, tmp_path / "pytorch_model.bin")
            tree = tconv.convert_streammind_checkpoint(str(tmp_path), full)
            assert tree["text"]["layers"]["experts"]["down"].shape == (2, 4, 64, 128)
            assert torch.equal(tree["text"]["layers"]["experts"]["up"][1, 3],
                               sd["model.layers.1.block_sparse_moe.experts.3.w3.weight"])


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu", "stc_connector", "identity"])
def test_convert_projector_dispatch_other_types_bitwise(ptype):
    """The projector types once refused here convert bitwise as the JAX
    package's dispatch converts them, from the released layouts under the
    model.mm_projector. prefix (STC: timm's names, the gate embedded)."""
    from test_torch_connectors import connector_state_dict, gate_state_dict

    tcfg = tconfig.tiny_streammind_config().replace(mm_projector_type=ptype)
    jcfg = tiny_streammind_config().replace(mm_projector_type=ptype)
    h, d = tcfg.text.hidden_size, tcfg.mm_hidden_size
    rng = np.random.default_rng(8)
    if ptype == "stc_connector":
        sd, _ = connector_state_dict(ptype)
        sd.update({f"cls_net.cls_model.{k}": v for k, v in gate_state_dict(tcfg).items()})
    else:
        shapes = {"linear": {"weight": (h, d), "bias": (h,)},
                  "mlp2x_gelu": {"0.weight": (h, d), "0.bias": (h,), "2.weight": (h, h),
                                 "2.bias": (h,)},
                  "identity": {}}[ptype]
        sd = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    sd = {f"model.mm_projector.{k}": v for k, v in sd.items()}
    for dtype in (torch.float32, torch.bfloat16):
        t = tconv.convert_projector_dispatch(sd, tcfg, dtype)
        _assert_trees_bitwise(t, jconv.convert_projector_dispatch(_sd_numpy(sd), jcfg,
                                                                  JAX_DTYPE[dtype]))
    assert ("cls_net" in t) == (ptype == "stc_connector") and (t == {}) == (ptype == "identity")


def test_model_init_from_checkpoint_matches_jax(tmp_path):
    """model_init(path): the config from streammind_config.json, the tree
    from a full-SFT .safetensors checkpoint, and greedy infer equal to the
    JAX package's model_init on the same directory (which reads it through
    a .bin copy: its safetensors path has no bf16)."""
    st = pytest.importorskip("safetensors.torch")
    cfg = tiny_streammind_config()
    sd = _synth_sd(_tiny_manifest(cfg), 8)
    tdir, jdir = tmp_path / "StreamMind-tiny", tmp_path / "jax-copy"
    tdir.mkdir()
    jdir.mkdir()
    st.save_file(sd, str(tdir / "model.safetensors"))
    torch.save(sd, jdir / "pytorch_model.bin")
    for d in (tdir, jdir):
        (d / "streammind_config.json").write_text(cfg.to_json())
    tok = SPLikeTokenizer()
    tm, _, _, version = tapi.model_init(str(tdir), tokenizer=tok, dtype=torch.float32,
                                        device="cpu")
    jm, _, _, _ = japi.model_init(str(jdir), tokenizer=tok, dtype=jnp.float32)
    assert version == "llama_2" and tm.cfg == tconfig.tiny_streammind_config()
    video = np.random.default_rng(9).standard_normal((3, 3, 56, 56)).astype(np.float32)
    a = japi.infer(jm, video, "Describe.", tok, max_new_tokens=6)
    assert tapi.infer(tm, video, "Describe.", tok, max_new_tokens=6) == a


def test_model_init_checkpoint_edge_cases(tmp_path):
    cfg = tconfig.tiny_streammind_config()
    tok = SPLikeTokenizer()
    with pytest.raises(FileNotFoundError, match="not a local checkpoint directory"):
        tapi.model_init(str(tmp_path / "missing"), cfg=cfg, tokenizer=tok, device="cpu")
    # a checkpoint without the vision tower: random vision, with a warning
    jcfg = tiny_streammind_config()
    torch.save(_synth_sd(_tiny_manifest(jcfg, vision=False), 10), tmp_path / "pytorch_model.bin")
    with pytest.warns(UserWarning, match="vision"):
        model, _, got_tok, _ = tapi.model_init(str(tmp_path), cfg=cfg, tokenizer=tok,
                                               dtype=torch.float32, device="cpu")
    assert set(model.params) == {"vision", "projector", "text"} and got_tok is tok
    # an HF config.json: the decoder from it, the gate at its width; Qwen2 refused
    hf = {"model_type": "mistral", "hidden_size": 64, "num_attention_heads": 4,
          "num_key_value_heads": 2, "num_hidden_layers": 2, "intermediate_size": 128,
          "vocab_size": 256}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert tapi._load_config(str(tmp_path)) == japi_config(str(tmp_path))
    # Qwen2: the same config in both packages, whose Mamba stays at 4096 while
    # the decoder is 64 wide; the port refuses it before building anything
    (tmp_path / "config.json").write_text(json.dumps(dict(hf, model_type="qwen2")))
    assert tapi._load_config(str(tmp_path)) == japi_config(str(tmp_path))
    with pytest.raises(ValueError, match="d_model 4096 differs"):
        tapi.model_init(str(tmp_path), tokenizer=tok, device="cpu")


@pytest.mark.parametrize("flag", [dict(load_8bit=True), dict(load_4bit=True),
                                  dict(load_4bit="pc")], ids=["int8", "int4", "int4pc"])
def test_model_init_quantizes_the_decoder_a_layer_at_a_time(tmp_path, monkeypatch, flag):
    """model_init(load_8bit / load_4bit) over a decoder it draws from a seed
    or loads from a checkpoint directory (a tiny Mixtral: expert banks)
    quantizes one layer at a time, so the device never holds the whole
    decoder in full precision: every quantize call sees one layer, and the
    served tree is bitwise what quantizing the whole decoder gives (the
    checkpoint) or the per-layer draws give (the seed)."""
    from streammind_torch.models import mistral as tlm
    from streammind_torch.models.meta import init_projector
    from streammind_torch.models.vit import init_vit_params
    from streammind_torch.utils import quantize as tquant
    from streammind_torch.utils.params import tree_leaves

    small = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                 num_attention_heads=4, num_key_value_heads=2)
    text = tconfig.text_config_from_hf(dict(small, model_type="mixtral", num_local_experts=4,
                                            num_experts_per_tok=2))
    cfg = tconfig.tiny_streammind_config().replace(text=text)
    bits = 8 if "load_8bit" in flag else 4
    qkw = dict(bits=bits, scheme="pc" if flag.get("load_4bit") == "pc" else "group")
    seen, real = [], tquant.quantize_text_params

    def spy(tree, **kw):
        seen.append({t.shape[0] for t in tree_leaves(tree["layers"])})
        return real(tree, **kw)

    monkeypatch.setattr(tquant, "quantize_text_params", spy)

    def quant(layers):
        return real({"layers": layers}, free_source=True, **qkw)["layers"]

    def assert_bitwise(got, want, path="text"):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                assert_bitwise(got[k], want[k], f"{path}.{k}")
        else:
            assert got.dtype == want.dtype and torch.equal(got, want), path

    # a seed: the layers drawn one at a time through the quantizer
    model, _, _, _ = tapi.model_init(cfg=cfg, seed=5, dtype=torch.float32, device="cpu", **flag)
    assert seen == [{1}] * 3
    g = torch.Generator().manual_seed(5)
    init_vit_params(g, cfg.vision, device="cpu", dtype=torch.float32)
    init_projector(g, cfg, device="cpu", dtype=torch.float32)
    want = tlm.init_text_params(g, cfg.text, device="cpu", dtype=torch.float32, layer_fn=quant)
    assert_bitwise(model.params["text"], tlm.fuse_text_linears(want))

    # a checkpoint directory: the converted decoder quantized layer by layer
    torch.manual_seed(2)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **small, num_local_experts=4, num_experts_per_tok=2))
    torch.save(_sd_torch(hf), tmp_path / "pytorch_model.bin")
    seen.clear()
    with pytest.warns(UserWarning, match="vision"):
        model, _, _, _ = tapi.model_init(str(tmp_path), cfg=cfg, tokenizer=SPLikeTokenizer(),
                                         dtype=torch.float32, device="cpu", **flag)
    assert seen == [{1}] * 3
    whole = tconv.convert_streammind_checkpoint(str(tmp_path), cfg, torch.float32)["text"]
    want = real(whole, **qkw)
    assert_bitwise(model.params["text"], tlm.fuse_text_linears(want))


def japi_config(path):
    """The JAX package's _load_config, carried over through its JSON."""
    return tconfig.StreamMindConfig.from_json(japi._load_config(path).to_json())


@pytest.mark.parametrize("helper", ["flatten_with_paths", "param_count", "cast_tree",
                                    "stack_layers"])
def test_param_tree_helpers_match_jax(helper):
    """The port's tree helpers against the JAX package's on one carried-over
    tree (dicts, a layer stack, an integer leaf); flatten_with_paths also
    keys a list's items by index, which the JAX package's leaves whole."""
    from streammind_torch.utils import params as tparams
    from streammind_tpu.utils import params as jparams

    rng = np.random.default_rng(0)
    layers = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
               "ids": np.arange(3, dtype=np.int32) + i} for i in range(2)]
    jtree = {"a": {"w": jnp.asarray(layers[0]["w"]), "ids": jnp.asarray(layers[0]["ids"])},
             "b": jnp.asarray(rng.standard_normal(5).astype(np.float32))}
    ttree = {"a": {k: array_to_tensor(np.asarray(v)) for k, v in jtree["a"].items()},
             "b": array_to_tensor(np.asarray(jtree["b"]))}
    if helper == "flatten_with_paths":
        want = dict(jparams.flatten_with_paths(jtree))
        got = dict(tparams.flatten_with_paths(ttree))
        assert list(got) == list(want) == ["a.w", "a.ids", "b"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        listed = dict(tparams.flatten_with_paths({"blocks": [ttree["b"], ttree["a"]]}))
        assert list(listed) == ["blocks.0", "blocks.1.w", "blocks.1.ids"]
    elif helper == "param_count":
        assert tparams.param_count(ttree) == jparams.param_count(jtree) == 12 + 3 + 5
    elif helper == "cast_tree":
        want = jparams.cast_tree(jtree, jnp.bfloat16)
        got = tparams.cast_tree(ttree, torch.bfloat16)
        assert got["a"]["ids"].dtype == torch.int32 and got["b"].dtype == torch.bfloat16
        for k, w in jparams.flatten_with_paths(want):
            g = dict(tparams.flatten_with_paths(got))[k]
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))
    else:
        want = jparams.stack_layers([jax.tree.map(jnp.asarray, p) for p in layers])
        got = tparams.stack_layers([{k: torch.from_numpy(v) for k, v in p.items()}
                                    for p in layers])
        for k in ("w", "ids"):
            assert got[k].shape == (2, *layers[0][k].shape)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
