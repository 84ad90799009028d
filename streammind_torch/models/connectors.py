"""Spatial-temporal connectors: the VideoLLaMA2 projectors.

The JAX package's ``models/connectors.py``, one function for each:
  - STC (``stc_forward``, variant "stc"): a RegNet stage over each frame's
    patch grid, a Conv3d downsample over (t, h, w) with kernel and stride
    (2, 2, 2) and padding 1, SiLU, a second RegNet stage, then a 2-layer GELU
    MLP readout of the flattened (t, h, w) tokens;
  - STP (variant "stp"): AvgPool3d (2, 2, 2) in place of the Conv3d;
  - STC v35 (variant "stc_v35"): the Conv3d without padding;
  - spatial_conv / spatial_pool: depth-0 STC / STP connectors (identity
    stages) that downsample (1, 2, 2).

A RegNet block is timm's Bottleneck with LayerNorm2d and SiLU: a 1×1 conv,
a grouped 3×3 conv (groups of 64 channels), squeeze-excite, a 1×1 conv,
each conv followed by LayerNorm2d, and a residual that a 1×1 conv (and, in
converted timm weights, its LayerNorm2d: ``proj_ln``) projects where the
width changes.  Weights are OIHW / OIDHW, torch's own layout.  The
convolutions, pools and norms are the library's calls (cuDNN on the card),
as XLA's are in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import StreamMindConfig
from ..utils.params import linear, normal_init, ones, torch_linear_init, zeros


# ---------------------------------------------------------------------------
# Primitives (NCHW / NCDHW)
# ---------------------------------------------------------------------------
def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding="SAME",
           groups: int = 1) -> torch.Tensor:
    """x (N, C, H, W), w (O, C / groups, kh, kw).  "SAME" at stride 1 pads an
    odd kernel k by k // 2 on each side."""
    if padding == "SAME":
        if stride != 1 or w.shape[-1] % 2 == 0:
            raise ValueError(f"conv2d: 'SAME' needs stride 1 and an odd kernel, got stride "
                             f"{stride}, kernel {tuple(w.shape[-2:])}")
        padding = w.shape[-1] // 2
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride, padding,
                    groups=groups)


def conv3d(x: torch.Tensor, w: torch.Tensor, b=None, stride=(1, 1, 1),
           padding=0) -> torch.Tensor:
    """x (N, C, T, H, W), w (O, C, kt, kh, kw); ``padding`` pads each side."""
    return F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride, padding)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the channels of (N, C, H, W) (timm's LayerNorm2d): the
    population variance, eps 1e-6."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), weight.to(x.dtype),
                     bias.to(x.dtype), eps)
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# RegNet stage
# ---------------------------------------------------------------------------
_GROUP_WIDTH = 64
_SE_RATIO = 0.25


def _init_conv(g: torch.Generator, out_c: int, in_c: int, k: int, device, dtype):
    return normal_init(g, (out_c, in_c, k, k), std=math.sqrt(2.0 / (in_c * k * k)),
                       device=device, dtype=dtype)


def _group_count(out_c: int) -> int:
    """The largest divisor of out_c not above out_c // 64 (groups of 64
    channels; any width must divide evenly)."""
    n = max(out_c // _GROUP_WIDTH, 1)
    while n > 1 and out_c % n != 0:
        n -= 1
    return n


def _affine(c: int, device, dtype) -> dict:
    return {"weight": ones((c,), device, dtype), "bias": zeros((c,), device, dtype)}


def init_reg_block(g: torch.Generator, in_c: int, out_c: int, device="cuda",
                   dtype=torch.float32) -> dict:
    groups = _group_count(out_c)
    se_c = max(int(in_c * _SE_RATIO), 8)
    kw = dict(device=device, dtype=dtype)
    p = {
        "conv1": _init_conv(g, out_c, in_c, 1, **kw),
        "ln1": _affine(out_c, **kw),
        "conv2": _init_conv(g, out_c, out_c // groups, 3, **kw),
        "ln2": _affine(out_c, **kw),
        "se_fc1": _init_conv(g, se_c, out_c, 1, **kw),
        "se_fc2": _init_conv(g, out_c, se_c, 1, **kw),
        "conv3": _init_conv(g, out_c, out_c, 1, **kw),
        "ln3": _affine(out_c, **kw),
    }
    if in_c != out_c:
        p["proj"] = _init_conv(g, out_c, in_c, 1, **kw)
    return p


def _ln(x, p):
    return layer_norm_2d(x, p["weight"], p["bias"])


def reg_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    shortcut = x
    if "proj" in p:
        # timm's downsample is conv + norm; a drawn tree has no norm there
        shortcut = conv2d(x, p["proj"])
        if "proj_ln" in p:
            shortcut = _ln(shortcut, p["proj_ln"])
    y = F.silu(_ln(conv2d(x, p["conv1"]), p["ln1"]))
    groups = p["conv2"].shape[0] // p["conv2"].shape[1]  # (O, O / groups, 3, 3)
    y = F.silu(_ln(conv2d(y, p["conv2"], groups=groups), p["ln2"]))
    # squeeze-excite (timm's carries conv biases; a drawn tree's has none)
    se = y.mean(dim=(2, 3), keepdim=True)
    se = F.silu(conv2d(se, p["se_fc1"], p.get("se_fc1_bias")))
    se = torch.sigmoid(conv2d(se, p["se_fc2"], p.get("se_fc2_bias")))
    y = _ln(conv2d(y * se, p["conv3"]), p["ln3"])
    return F.silu(shortcut + y)


def init_reg_stage(g: torch.Generator, depth: int, in_c: int, out_c: int, device="cuda",
                   dtype=torch.float32) -> list:
    return [init_reg_block(g, in_c if i == 0 else out_c, out_c, device, dtype)
            for i in range(depth)]


def reg_stage(x: torch.Tensor, blocks: list) -> torch.Tensor:
    for b in blocks:
        x = reg_block(x, b)
    return x


# ---------------------------------------------------------------------------
# Connectors
# ---------------------------------------------------------------------------
def init_stc_connector(g: torch.Generator, cfg: StreamMindConfig, depth: int = 4,
                       mlp_depth: int = 2, downsample=(2, 2, 2), variant: str = "stc",
                       device="cuda", dtype=torch.float32) -> dict:
    """depth 0 (spatial_conv / spatial_pool) has identity stages, so the
    sampler takes the encoder's channels and, for the pool, so does the
    readout's first layer."""
    enc, hid = cfg.mm_hidden_size, cfg.text.hidden_size
    conv_in = enc if depth == 0 else hid
    read_in = hid if variant in ("stc", "stc_v35") or depth > 0 else enc
    kw = dict(device=device, dtype=dtype)
    p = {
        "s1": init_reg_stage(g, depth, enc, hid, **kw),
        "s2": init_reg_stage(g, depth, hid, hid, **kw),
        "readout": [torch_linear_init(g, hid, read_in, **kw)]
        + [torch_linear_init(g, hid, hid, **kw) for _ in range(mlp_depth - 1)],
    }
    if variant in ("stc", "stc_v35"):
        dt, dh, dw = downsample
        p["sampler"] = {
            "weight": normal_init(g, (hid, conv_in, dt, dh, dw),
                                  std=math.sqrt(2.0 / (conv_in * dt * dh * dw)), **kw),
            "bias": zeros((hid,), **kw),
        }
    return p


def _sample(x: torch.Tensor, p: dict, variant: str, downsample) -> torch.Tensor:
    """The 3D downsample, then SiLU: the Conv3d (padding 1 for "stc", none
    for "stc_v35") or the average over each window ("stp"), floored at the
    edges.  An unpadded window longer than the clip leaves no output
    position (0 tokens), as XLA's VALID window gives."""
    if variant == "stc":
        return F.silu(conv3d(x, p["sampler"]["weight"], p["sampler"]["bias"],
                             stride=downsample, padding=1))
    sizes = [(n - k) // k + 1 if n >= k else 0 for n, k in zip(x.shape[2:], downsample)]
    if 0 in sizes:
        c = p["sampler"]["weight"].shape[0] if variant == "stc_v35" else x.shape[1]
        return x.new_zeros((x.shape[0], c, *sizes))
    if variant == "stc_v35":
        return F.silu(conv3d(x, p["sampler"]["weight"], p["sampler"]["bias"],
                             stride=downsample))
    # the window average as a reshape and a mean (any dtype, any device)
    b, c = x.shape[:2]
    (nt, nh, nw), (kt, kh, kw) = sizes, downsample
    x = x[:, :, :nt * kt, :nh * kh, :nw * kw].reshape(b, c, nt, kt, nh, kh, nw, kw)
    return F.silu(x.mean(dim=(3, 5, 7)))


def stc_forward(x: torch.Tensor, p: dict, variant: str = "stc",
                downsample=(2, 2, 2)) -> torch.Tensor:
    """(B, T, L, D) patch features → (B, tokens, hidden): the first stage on
    each frame's sqrt(L) × sqrt(L) grid, the 3D downsample over (t, h, w),
    the second stage on each downsampled frame, then the readout over the
    tokens in (t, h, w) order."""
    b, t, l, d = x.shape
    hw = math.isqrt(l)
    x2 = reg_stage(x.reshape(b * t, hw, hw, d).permute(0, 3, 1, 2), p["s1"])
    x = x2.reshape(b, t, x2.shape[1], hw, hw).transpose(1, 2)  # (B, C, T, H, W)

    x = _sample(x, p, variant, downsample)

    c, nt, nh, nw = x.shape[1:]  # depth-0 pools keep the encoder's channels
    x2 = reg_stage(x.transpose(1, 2).reshape(b * nt, c, nh, nw), p["s2"])
    x = x2.reshape(b, nt, c, nh, nw).permute(0, 1, 3, 4, 2).reshape(b, nt * nh * nw, c)

    out = linear(x, p["readout"][0])
    for layer in p["readout"][1:]:
        out = linear(F.gelu(out), layer)
    return out


# spatial_conv / spatial_pool: depth-0 STC / STP connectors that downsample
# space alone, with a 2-layer readout
SPATIAL_DOWNSAMPLE = (1, 2, 2)


def init_spatial_conv(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                      dtype=torch.float32) -> dict:
    return init_stc_connector(g, cfg, depth=0, mlp_depth=2, downsample=SPATIAL_DOWNSAMPLE,
                              variant="stc", device=device, dtype=dtype)


def init_spatial_pool(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                      dtype=torch.float32) -> dict:
    return init_stc_connector(g, cfg, depth=0, mlp_depth=2, downsample=SPATIAL_DOWNSAMPLE,
                              variant="stp", device=device, dtype=dtype)


def spatial_conv_forward(x: torch.Tensor, p: dict) -> torch.Tensor:
    return stc_forward(x, p, variant="stc", downsample=SPATIAL_DOWNSAMPLE)


def spatial_pool_forward(x: torch.Tensor, p: dict) -> torch.Tensor:
    return stc_forward(x, p, variant="stp", downsample=SPATIAL_DOWNSAMPLE)
