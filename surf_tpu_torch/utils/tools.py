"""Host-side helpers (torch counterpart of surf_tpu/utils/tools.py, the
reference's utils/tools.py): device transfer, scalar conversion,
TensorBoard scalars, running averages, seeding."""

from __future__ import annotations

import numpy as np
import torch

from .summary import DictAverageMeter, save_scalars

__all__ = ["to_device", "tensor2float", "save_scalars", "DictAverageMeter", "setup_seed"]


def to_device(data, device):
    """Dicts, lists and tuples of numpy arrays, numpy scalars, Python
    numbers and tensors, each leaf as a tensor on ``device`` (the
    reference's ``tocuda``, utils/tools.py:82); other leaves unchanged."""
    if isinstance(data, dict):
        return {k: to_device(v, device) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(to_device(v, device) for v in data)
    if isinstance(data, torch.Tensor):
        return data.to(device)
    if isinstance(data, (np.ndarray, np.generic, int, float)):
        return torch.as_tensor(np.asarray(data), device=device)
    return data


def tensor2float(d):
    """Each value of ``d`` as a float where it converts, else as it is."""
    out = {}
    for k, v in d.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


def setup_seed(seed):
    """Seeds numpy's global generator; returns a ``torch.Generator`` seeded
    with ``seed`` (the JAX package returns a PRNG key)."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
