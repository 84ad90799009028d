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

Rotation keeps the newest ``keep`` checkpoints.
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
