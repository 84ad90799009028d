"""The port's VideoLLaMA2 projectors against the JAX package's, on the CPU.

Every projector type (the STC / STP / v35 connectors, spatial_conv /
spatial_pool, linear, mlp2x_gelu, identity): the drawn tree's structure
and shapes, ``simple_project`` and ``project_memory`` on one carried-over
tree, and ``projected_token_count`` at 1-8 frames over two patch grids.
The converters: a timm-named connector state dict (a small mirror of timm's
RegStage Bottleneck, whose state-dict names the released connectors carry)
and the spatial layouts with an embedded gate, bitwise against the JAX
package's converters, and forward against the mirror; linear and MLP
``mm_projector.bin`` files through ``convert_streammind_checkpoint``.
``api.infer``'s greedy tokens over stc_connector and mlp2x_gelu (and one
``sample_type="log"`` case) against the JAX package's.  A streaming
session or server over a clip projector is refused.

fp32.  Tolerances: projections 1e-5 + 1e-5·|ref| against JAX (measured
~2e-6: the same sums in another order through a few convolutions); 2e-4
against the torch mirror (its convolutions run in another order too);
converters bitwise; token counts and greedy tokens exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import streammind_tpu.api as japi
from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.models import projector as tproj
from streammind_torch.streaming.multistream import MultiStreamServer
from streammind_torch.utils import convert as tconv
from streammind_torch.utils.from_jax import array_to_tensor, params_from_numpy
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models import projector as jproj
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.utils import convert as jconv

TYPES = ["stc_connector", "stp_connector", "stc_connector_v35", "spatial_conv", "spatial_pool",
         "linear", "mlp2x_gelu", "identity"]
CONNECTORS = TYPES[:5]
TOL = dict(rtol=1e-5, atol=1e-5)
MIRROR_TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(ptype):
    return (tiny_streammind_config().replace(mm_projector_type=ptype),
            tconfig.tiny_streammind_config().replace(mm_projector_type=ptype))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _feats(seed, t=4, n=16, d=32, b=2):
    return np.random.default_rng(seed).standard_normal((b, t, n, d)).astype(np.float32)


def _assert_bitwise(t_tree, j_tree, path="projector"):
    if isinstance(j_tree, dict):
        assert isinstance(t_tree, dict) and set(t_tree) == set(j_tree), path
        for k in j_tree:
            _assert_bitwise(t_tree[k], j_tree[k], f"{path}.{k}")
    elif isinstance(j_tree, (list, tuple)):
        assert len(t_tree) == len(j_tree), path
        for i, (a, b) in enumerate(zip(t_tree, j_tree)):
            _assert_bitwise(a, b, f"{path}.{i}")
    else:
        want = array_to_tensor(np.asarray(j_tree))
        assert t_tree.dtype == want.dtype and t_tree.shape == want.shape, path
        assert torch.equal(t_tree.view(torch.int16) if t_tree.dtype == torch.bfloat16 else t_tree,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want), path


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# a small mirror of the released connectors (timm's RegStage Bottleneck with
# LayerNorm2d and SiLU; the names of its state dict are timm's)
# ---------------------------------------------------------------------------
class LayerNorm2d(nn.LayerNorm):
    def __init__(self, c):
        super().__init__(c, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape, self.weight,
                            self.bias, self.eps).permute(0, 3, 1, 2)


class ConvNormAct(nn.Module):
    def __init__(self, i, o, k, groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(i, o, k, padding=k // 2, groups=groups, bias=False)
        self.bn = LayerNorm2d(o)  # timm names the norm 'bn' whatever it is
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class SE(nn.Module):
    def __init__(self, c, rd):
        super().__init__()
        self.fc1 = nn.Conv2d(c, rd, 1)
        self.fc2 = nn.Conv2d(rd, c, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(x.mean((2, 3), keepdim=True)))))


class Bottleneck(nn.Module):
    def __init__(self, i, o, groups):
        super().__init__()
        self.conv1 = ConvNormAct(i, o, 1)
        self.conv2 = ConvNormAct(o, o, 3, groups=groups)
        self.se = SE(o, max(int(i * 0.25), 1))
        self.conv3 = ConvNormAct(o, o, 1, act=False)
        self.downsample = ConvNormAct(i, o, 1, act=False) if i != o else None

    def forward(self, x):
        sc = self.downsample(x) if self.downsample is not None else x
        return F.silu(self.conv3(self.se(self.conv2(self.conv1(x)))) + sc)


class Stage(nn.Sequential):
    def __init__(self, depth, i, o, groups):
        super().__init__()
        for n in range(depth):
            self.add_module(f"b{n + 1}", Bottleneck(i if n == 0 else o, o, groups))


class MirrorConnector(nn.Module):
    """STCConnector.forward: stage, 3D sampler + SiLU, stage, readout."""

    def __init__(self, enc, hid, depth, variant, downsample, groups=2):
        super().__init__()
        self.s1 = Stage(depth, enc, hid, groups)
        c = hid if depth else enc
        if variant == "stp":
            self.sampler = nn.Sequential(nn.AvgPool3d(downsample), nn.SiLU())
        else:
            self.sampler = nn.Sequential(
                nn.Conv3d(c, hid, downsample, stride=downsample,
                          padding=1 if variant == "stc" else 0), nn.SiLU())
            c = hid
        self.s2 = Stage(depth, hid, hid, groups)
        self.readout = nn.Sequential(nn.Linear(c, hid), nn.GELU(), nn.Linear(hid, hid))

    def forward(self, x):
        b, t, l, d = x.shape
        hw = int(l ** 0.5)
        x = self.s1(x.reshape(b * t, hw, hw, d).permute(0, 3, 1, 2))
        x = self.sampler(x.reshape(b, t, *x.shape[1:]).transpose(1, 2))
        c, nt, nh, nw = x.shape[1:]
        x = self.s2(x.transpose(1, 2).reshape(b * nt, c, nh, nw))
        return self.readout(x.reshape(b, nt, c, nh, nw).permute(0, 1, 3, 4, 2).reshape(b, -1, c))


_MIRRORED = {"stc_connector": ("stc", 4, (2, 2, 2)), "stp_connector": ("stp", 4, (2, 2, 2)),
             "stc_connector_v35": ("stc_v35", 4, (2, 2, 2)),
             "spatial_conv": ("stc", 0, (1, 2, 2)), "spatial_pool": ("stp", 0, (1, 2, 2))}


def connector_state_dict(ptype, seed=3, enc=32, hid=64):
    """The timm-named state dict (and the module) of a ``ptype`` connector
    at the tiny widths; the released connectors are 4 stages deep."""
    variant, depth, ds = _MIRRORED[ptype]
    torch.manual_seed(seed)
    model = MirrorConnector(enc, hid, depth, variant, ds).eval()
    with torch.no_grad():  # off the init's ones and zeros, so the norms are read
        for name, p in model.named_parameters():
            if ".bn." in name:
                p.add_(0.1 * torch.randn(p.shape))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, model


def gate_state_dict(cfg, seed=6):
    """A gate LM's state dict in HF Mistral naming, seeded."""
    g, rng = cfg.gate, np.random.default_rng(seed)
    shapes = {"model.embed_tokens.weight": (g.vocab_size, g.hidden_size),
              "model.norm.weight": (g.hidden_size,), "lm_head.weight": (g.vocab_size, g.hidden_size)}
    for i in range(g.num_layers):
        pre = f"model.layers.{i}."
        shapes.update({pre + "input_layernorm.weight": (g.hidden_size,),
                       pre + "post_attention_layernorm.weight": (g.hidden_size,),
                       pre + "self_attn.q_proj.weight": (g.num_heads * g.head_dim, g.hidden_size),
                       pre + "self_attn.k_proj.weight": (g.num_kv_heads * g.head_dim,
                                                         g.hidden_size),
                       pre + "self_attn.v_proj.weight": (g.num_kv_heads * g.head_dim,
                                                         g.hidden_size),
                       pre + "self_attn.o_proj.weight": (g.hidden_size, g.num_heads * g.head_dim),
                       pre + "mlp.gate_proj.weight": (g.intermediate_size, g.hidden_size),
                       pre + "mlp.up_proj.weight": (g.intermediate_size, g.hidden_size),
                       pre + "mlp.down_proj.weight": (g.hidden_size, g.intermediate_size)})
    return {k: torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32))
            for k, s in sorted(shapes.items())}


# ---------------------------------------------------------------------------
# trees, forwards and token counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ptype", TYPES)
def test_init_projector_tree_matches_jax(ptype):
    jcfg, tcfg = _cfgs(ptype)
    j = jproj.init_projector_params(jax.random.PRNGKey(7), jcfg)
    t = tproj.init_projector_params(torch.Generator().manual_seed(7), tcfg, device="cpu")
    assert _shapes(t) == _shapes(jax.tree.map(np.asarray, j))
    assert ("cls_net" in t) == (ptype in CONNECTORS)


@pytest.mark.parametrize("ptype", TYPES)
def test_projection_matches_jax(ptype):
    jcfg, tcfg = _cfgs(ptype)
    jp = jproj.init_projector_params(jax.random.PRNGKey(9), jcfg)
    tp = _carry(jp)
    x = _feats(1)
    want = np.asarray(jproj.simple_project(jp, jcfg, jnp.asarray(x)))
    got = tproj.simple_project(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # project_memory dispatches by type and takes (and ignores) impl
    mem = tproj.project_memory(tp, tcfg, torch.from_numpy(x), impl="pallas")
    np.testing.assert_allclose(mem.numpy(), np.asarray(jproj.project_memory(jp, jcfg,
                                                                           jnp.asarray(x))), **TOL)
    assert mem.shape[1] == tproj.projected_token_count(tcfg, 4, 16)


@pytest.mark.parametrize("n_patches", [16, 36])
@pytest.mark.parametrize("ptype", TYPES)
def test_projected_token_count_matches_jax(ptype, n_patches):
    jcfg, tcfg = _cfgs(ptype)
    for t in (1, 2, 3, 4, 8):
        assert (tproj.projected_token_count(tcfg, t, n_patches)
                == jproj.projected_token_count(jcfg, t, n_patches)), t


def test_cls_patch_tokens_refused_as_in_jax():
    """577 tokens (the CLS token kept) have no square grid: both packages
    fail to reshape them."""
    jcfg, tcfg = _cfgs("stc_connector")
    with pytest.raises(Exception):
        jproj.projected_token_count(jcfg, 2, 577)
    with pytest.raises(RuntimeError):
        tproj.projected_token_count(tcfg, 2, 577)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ptype", CONNECTORS)
def test_connector_converters_bitwise_and_mirror(ptype, dtype):
    """A timm-named connector state dict with its gate embedded, under the
    ``mm_projector.`` prefix: the converted tree bitwise the JAX package's,
    and (fp32) the port's forward that of the mirror."""
    jcfg, tcfg = _cfgs(ptype)
    sd, model = connector_state_dict(ptype)
    full = {f"mm_projector.{k}": v for k, v in sd.items()}
    full.update({f"mm_projector.cls_net.cls_model.{k}": v
                 for k, v in gate_state_dict(tcfg).items()})
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = jconv.convert_projector_dispatch({k: v.numpy() for k, v in full.items()}, jcfg, jdt)
    t = tconv.convert_projector_dispatch(full, tcfg, dtype)
    _assert_bitwise(t, j)
    assert "cls_net" in t
    if t["s1"]:  # the width changes in s1's first block: its projection carries a norm
        assert "proj_ln" in t["s1"][0] and "proj_ln" not in t["s1"][1]
    if dtype == torch.float32:
        x = _feats(2, t=4)
        with torch.no_grad():
            ref = model(torch.from_numpy(x)).numpy()
        got = tproj.simple_project(t, tcfg, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, **MIRROR_TOL)
        np.testing.assert_allclose(
            got, np.asarray(jproj.simple_project(j, jcfg, jnp.asarray(x))), **TOL)


def test_convert_stc_connector_without_prefix_matches_jax():
    """convert_stc_connector on a bare timm dict (depth 4, no gate)."""
    sd, _ = connector_state_dict("stc_connector", seed=11)
    _assert_bitwise(tconv.convert_stc_connector(sd),
                    jconv.convert_stc_connector({k: v.numpy() for k, v in sd.items()}))


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu"])
def test_simple_mm_projector_bin_through_checkpoint(tmp_path, ptype):
    """A linear / MLP mm_projector.bin (model.mm_projector. prefix) through
    convert_streammind_checkpoint in both packages: bitwise."""
    jcfg, tcfg = _cfgs(ptype)
    h, d = tcfg.text.hidden_size, tcfg.mm_hidden_size
    shapes = ({"weight": (h, d), "bias": (h,)} if ptype == "linear" else
              {"0.weight": (h, d), "0.bias": (h,), "2.weight": (h, h), "2.bias": (h,)})
    rng = np.random.default_rng(4)
    torch.save({f"model.mm_projector.{k}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()},
        tmp_path / "mm_projector.bin")
    j = jconv.convert_streammind_checkpoint(str(tmp_path), jcfg)
    t = tconv.convert_streammind_checkpoint(str(tmp_path), tcfg)
    assert set(t) == {"projector"}
    _assert_bitwise(t["projector"], j["projector"])


# ---------------------------------------------------------------------------
# the API over clip projectors
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["stc_connector", "mlp2x_gelu"])
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = init_streammind_params(jax.random.PRNGKey(0), jcfg)
    tok = SPLikeTokenizer()
    jm, _, _, _ = japi.model_init(cfg=jcfg, params=jp, tokenizer=tok, dtype=jnp.float32)
    tm, _, _, _ = tapi.model_init(cfg=tcfg, params=_carry(jp), tokenizer=tok,
                                  dtype=torch.float32, device="cpu")
    return jm, tm, tok


@pytest.mark.parametrize("case", [dict(), dict(sample_type="log", sample_per=0.5)],
                         ids=["plain", "log"])
def test_greedy_infer_matches_jax(models, case):
    jm, tm, tok = models
    s = tm.cfg.vision.image_size
    video = np.random.default_rng(5).standard_normal((4, 3, s, s)).astype(np.float32)
    jplan, jbuf = japi._prepare_cognition_inputs(jm, video, "What?", tok, "llama_2", **case)
    tplan, tbuf = tapi._prepare_cognition_inputs(tm, video, "What?", tok, "llama_2", **case)
    np.testing.assert_array_equal(tplan.token_ids, jplan.token_ids)
    np.testing.assert_array_equal(tplan.mem_index, jplan.mem_index)
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), **TOL)
    a = japi.infer(jm, video, "What?", tok, max_new_tokens=8, **case)
    b = tapi.infer(tm, video, "What?", tok, max_new_tokens=8, **case)
    assert b == a and b  # the tokenizer spells every id: equal text is equal ids


def test_streaming_refuses_clip_projectors(models):
    """The session and the multi-stream server need the mamba projector's
    per-frame step: refused before the first frame (the JAX package fails
    with a KeyError at it)."""
    _, tm, tok = models
    with pytest.raises(ValueError, match=tm.cfg.mm_projector_type):
        tm.new_session(tok)
    with pytest.raises(ValueError, match="mamba"):
        MultiStreamServer(tm.engine, capacity=2)
