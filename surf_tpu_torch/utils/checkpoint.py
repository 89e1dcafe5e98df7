"""Pytree checkpoints in one .npz, in the JAX package's layout
(surf_tpu/utils/checkpoint.py), so that either package loads what the
other wrote: paths are '/'-joined keys, list items '#i' under a
'__len__' / '__tuple__' pair, None a '__none__' flag, scalars 0-d
arrays."""

from __future__ import annotations

import os

import numpy as np
import torch

_LIST_TAG = "#"


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"checkpoint key with '/': {k}")
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}/__len__"] = np.asarray(len(tree))
        out[f"{prefix}/__tuple__"] = np.asarray(isinstance(tree, tuple))
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{_LIST_TAG}{i}", out)
    elif tree is None:
        out[f"{prefix}/__none__"] = np.asarray(True)
    else:
        out[prefix] = np.asarray(tree)


def save_checkpoint(path, tree):
    """Write ``tree`` (dicts, lists, tuples, None, numpy arrays, scalars;
    see ``to_numpy_tree`` for tensors) atomically to ``path``."""
    flat = {}
    _flatten(tree, "", flat)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    if "__none__" in node:
        return None
    if "__len__" in node:
        items = [_rebuild(node[f"{_LIST_TAG}{i}"]) for i in range(int(node["__len__"]))]
        return tuple(items) if bool(node.get("__tuple__", False)) else items
    return {k: _rebuild(v) for k, v in node.items()}


def load_checkpoint(path):
    """The tree saved at ``path``, with numpy arrays as leaves."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _rebuild(root)


def to_numpy_tree(tree):
    """Tensors -> numpy arrays (on the host), structure kept."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def to_torch_tree(tree, device=None):
    """numpy arrays -> tensors on ``device`` (copies: the source may be
    read-only), structure kept (tuples become lists, as the port's pytrees
    use lists)."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch_tree(v, device) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(tree), device=device)
    return tree
