"""Checkpoints in the JAX package's format, so one checkpoint loads in both.

``checkpoint-{step}`` directories, each with:
  - ``params.npz`` — one array per leaf, keyed by its "/"-joined path;
    bf16 leaves stored as fp32 (numpy cannot hold bf16) with the true dtype
    in the manifest;
  - ``params.json`` — the manifest: which paths are lists, and each leaf's
    shape and dtype;
  - ``meta.json`` — ``{"step", "adapter_only", ...}``;
  - optimizer state, for full checkpoints, in torch's format as
    ``opt_state_torch.pt``.  It cannot share optax's layout (optax's state
    is a tree of its own transforms), so the packages do not read each
    other's optimizer state: each starts a fresh one on the other's
    checkpoint, as each does when its own optimizer changed.

Rotation keeps the newest ``keep`` checkpoints.  ``save_mm_projector_bin``
writes a projector in the released ``mm_projector.bin`` layout, which
``utils.convert`` reads back.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

OPT_STATE_FILE = "opt_state_torch.pt"


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _list_paths(tree, prefix="") -> list:
    paths = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            paths.extend(_list_paths(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        paths.append(prefix)
        for i, v in enumerate(tree):
            paths.extend(_list_paths(v, f"{prefix}/{i}"))
    return paths


def _np_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as numpy: bf16 upcast to fp32 on disk, its true dtype named."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_tree(path: str, tree, name: str = "params") -> None:
    os.makedirs(path, exist_ok=True)
    stored, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        stored[k], dtypes[k] = _np_storable(v)
    np.savez(os.path.join(path, f"{name}.npz"), **stored)
    manifest = {
        "name": name,
        "list_paths": _list_paths(tree),
        "leaves": {k: [list(v.shape), dtypes[k]] for k, v in stored.items()},
    }
    with open(os.path.join(path, f"{name}.json"), "w") as f:
        json.dump(manifest, f)


def load_tree(path: str, name: str = "params", device="cpu"):
    """The tree of tensors on ``device``, each leaf in its recorded dtype."""
    with open(os.path.join(path, f"{name}.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, f"{name}.npz"))
    list_paths = set(manifest["list_paths"])
    root: Dict = {}
    for leaf_path in data.files:
        keys = leaf_path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        dtype = getattr(torch, manifest["leaves"][leaf_path][1])
        node[keys[-1]] = torch.from_numpy(np.array(data[leaf_path])).to(device=device,
                                                                        dtype=dtype)

    def fix(node, p=""):
        if not isinstance(node, dict):
            return node
        if p in list_paths:
            return [fix(node[str(i)], f"{p}/{i}") for i in range(len(node))]
        return {k: fix(v, f"{p}/{k}" if p else k) for k, v in node.items()}

    return fix(root)


def save_checkpoint(ckpt_root: str, step: int, params, opt_state=None,
                    adapter_only: bool = False, keep: int = 3,
                    extra: Optional[Dict] = None) -> str:
    """Write checkpoint-{step}; optionally only the projector subtree."""
    path = os.path.join(ckpt_root, f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    save_tree(path, {"projector": params["projector"]} if adapter_only else params, "params")
    if opt_state is not None:
        save_opt_state(path, opt_state)
    meta = {"step": step, "adapter_only": adapter_only}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    _rotate(ckpt_root, keep)
    return path


def _rotate(ckpt_root: str, keep: int):
    for old in sorted_checkpoints(ckpt_root)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_root, f"checkpoint-{old}"), ignore_errors=True)


def sorted_checkpoints(ckpt_root: str) -> list:
    if not os.path.isdir(ckpt_root):
        return []
    steps = []
    for d in os.listdir(ckpt_root):
        m = re.match(r"checkpoint-(\d+)$", d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(ckpt_root: str) -> Optional[str]:
    steps = sorted_checkpoints(ckpt_root)
    return os.path.join(ckpt_root, f"checkpoint-{steps[-1]}") if steps else None


def load_checkpoint(path: str, device="cpu") -> Tuple[Any, Optional[Any], Dict]:
    """(params, optimizer state or None, meta)."""
    params = load_tree(path, "params", device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, load_opt_state(path, device), meta


def save_opt_state(path: str, opt_state) -> None:
    torch.save(opt_state, os.path.join(path, OPT_STATE_FILE))


def load_opt_state(path: str, device="cpu"):
    f = os.path.join(path, OPT_STATE_FILE)
    if not os.path.exists(f):
        return None
    return torch.load(f, map_location=device, weights_only=True)


# ---------------------------------------------------------------------------
# mm_projector.bin: the released projector adapter layout
# ---------------------------------------------------------------------------
def export_projector_torch_sd(projector_params) -> Dict[str, torch.Tensor]:
    """A projector tree (unquantized, gate unfused) → the Video_Mamba_seq
    state-dict keys, CPU tensors (the inverse of
    ``utils.convert.convert_projector``)."""
    p = projector_params

    def t(x):
        return x.detach().cpu()

    sd: Dict[str, torch.Tensor] = {
        "pre_net.fc3.weight": t(p["pre_net"]["weight"]),
        "pre_net.fc3.bias": t(p["pre_net"]["bias"]),
        "post_net.fc3.weight": t(p["post_net"]["weight"]),
        "post_net.fc3.bias": t(p["post_net"]["bias"]),
        "mamba_model.norm_fn.weight": t(p["mamba"]["final_norm"]["weight"]),
        "mamba_model.norm_fn.bias": t(p["mamba"]["final_norm"]["bias"]),
    }
    for i, b in enumerate(p["mamba"]["blocks"]):
        mx = f"mamba_model.ssms.{i}.mixer."
        sd[f"mamba_model.ssms.{i}.norm.weight"] = t(b["norm"]["weight"])
        sd[f"mamba_model.ssms.{i}.norm.bias"] = t(b["norm"]["bias"])
        sd[mx + "in_proj.weight"] = t(b["in_proj"]["weight"])
        sd[mx + "conv1d.weight"] = t(b["conv1d"]["weight"])[:, None, :]
        if "bias" in b["conv1d"]:
            sd[mx + "conv1d.bias"] = t(b["conv1d"]["bias"])
        sd[mx + "x_proj.weight"] = t(b["x_proj"]["weight"])
        sd[mx + "dt_proj.weight"] = t(b["dt_proj"]["weight"])
        sd[mx + "dt_proj.bias"] = t(b["dt_proj"]["bias"])
        sd[mx + "A_log"] = t(b["A_log"])
        sd[mx + "D"] = t(b["D"])
        sd[mx + "out_proj.weight"] = t(b["out_proj"]["weight"])
    if "cls_net" in p:
        g = p["cls_net"]
        sd["cls_net.cls_model.model.embed_tokens.weight"] = t(g["embed_tokens"])
        sd["cls_net.cls_model.model.norm.weight"] = t(g["final_norm"]["weight"])
        if "lm_head" in g:
            sd["cls_net.cls_model.lm_head.weight"] = t(g["lm_head"]["weight"])
        layers = g["layers"]
        names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "o": "self_attn.o_proj", "input_norm": "input_layernorm",
                 "post_norm": "post_attention_layernorm"}
        for i in range(layers["q"]["weight"].shape[0]):
            base = f"cls_net.cls_model.model.layers.{i}."
            for ours, theirs in names.items():
                sd[base + theirs + ".weight"] = t(layers[ours]["weight"][i])
            for proj in ("gate", "up", "down"):
                sd[base + f"mlp.{proj}_proj.weight"] = t(layers["mlp"][proj]["weight"][i])
    return sd


def save_mm_projector_bin(projector_params, out_path: str) -> None:
    sd = {k: v.clone() for k, v in export_projector_torch_sd(projector_params).items()}
    torch.save(sd, out_path)
