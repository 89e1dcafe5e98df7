"""Pytree checkpoints in one .npz, in the JAX package's layout
(surf_tpu/utils/checkpoint.py), so that either package loads what the
other wrote: paths are '/'-joined keys, list items '#i' under a
'__len__' / '__tuple__' pair, None a '__none__' flag, scalars 0-d
arrays.

bfloat16 leaves are stored as ``np.savez`` stores an ml_dtypes bfloat16
array: the 2-byte void type, header descr ``'<V2'``, holding the bf16
bits.  ``to_numpy_tree`` turns a bf16 tensor into such a void array and
``to_torch_tree`` turns one back into bf16, so a bf16 volume is never
widened on disk.

The finetune layout (``vol_state_tree`` / ``vol_state_from_tree``): the
stage storages, the voxel grids as 4-tuples ``(parents, pvalid, cvalid,
parent_table)`` with the JAX dtypes (parents int32), the matching volume
and the FPN features of every view.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from ..ops.sparse import VoxelGrid

_LIST_TAG = "#"
_BF16_DESCR = "<V2"          # what np.savez writes for an ml_dtypes bfloat16


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


def _is_bf16_bits(a):
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and a.dtype.names is None


def _write_npy(fid, a):
    """``np.lib.format.write_array``, except that a bf16 leaf (2-byte void)
    gets the header an ml_dtypes bfloat16 array gets."""
    if not _is_bf16_bits(a):
        np.lib.format.write_array(fid, a, allow_pickle=False)
        return
    a = np.ascontiguousarray(a)
    np.lib.format.write_array_header_1_0(
        fid, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
    fid.write(a.tobytes())


def save_checkpoint(path, tree):
    """Write ``tree`` (dicts, lists, tuples, None, numpy arrays, scalars;
    see ``to_numpy_tree`` for tensors) atomically to ``path``, member by
    member as ``np.savez`` writes it."""
    flat = {}
    _flatten(tree, "", flat)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, a)
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
    """The tree saved at ``path``, with numpy arrays as leaves (bf16 leaves
    as 2-byte void arrays)."""
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
    """Tensors -> numpy arrays (on the host), structure kept; a bf16
    tensor becomes a 2-byte void array of its bits."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return tree


def to_torch_tree(tree, device=None):
    """numpy arrays -> tensors on ``device`` (copies: the source may be
    read-only), structure kept (tuples become lists, as the port's pytrees
    use lists); a 2-byte void array is read as bf16 bits."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch_tree(v, device) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.array(tree)
        if _is_bf16_bits(a):
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.as_tensor(a, device=device)
    return tree


def vol_state_tree(vol_state):
    """A finetune ``vol_state`` (tensors; grids as ``VoxelGrid``) as the
    JAX package saves it: numpy leaves, grids as 4-tuples with int32
    parents."""
    grids = [(g.parents.to(torch.int32), g.pvalid, g.cvalid, g.parent_table)
             for g in vol_state["grids"]]
    return to_numpy_tree({"volumes": list(vol_state["volumes"]), "grids": grids,
                          "matching_volume": vol_state["matching_volume"],
                          "features": list(vol_state["features"])})


def vol_state_from_tree(tree, device=None):
    """The inverse of ``vol_state_tree`` (either package's file): tensors on
    ``device``, grids rebuilt as the port's ``VoxelGrid`` (int64 parents)."""
    t = to_torch_tree(tree, device)
    return {"volumes": t["volumes"],
            "grids": [VoxelGrid(p.long(), pv, cv, pt) for p, pv, cv, pt in t["grids"]],
            "matching_volume": t["matching_volume"], "features": t["features"]}


def resume_from(path, params, state, *, load_vol=False, device=None):
    """``--resume`` (surf_tpu/runner.py:162-178) over the seeded init's
    ``params`` and ``state``: returns (params, state, vol_state).  A model
    checkpoint replaces both (the state if it has one) and gives no
    vol_state; with ``load_vol`` a finetune checkpoint gives its vol_state
    and the implicit surface, and everything else stays as given."""
    ck = load_checkpoint(path)
    if load_vol:
        params = dict(params, implicit_surface=to_torch_tree(
            ck["model"]["implicit_surface"], device))
        return params, state, vol_state_from_tree(ck["model"]["vol_state"], device)
    if "state" in ck:
        state = to_torch_tree(ck["state"], device)
    return to_torch_tree(ck["model"], device), state, None
