"""Parameter intake from the JAX package: ``from_jax(params_np, state_np)``
turns its parameter and state pytrees, given as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), into the port's pytrees of
torch tensors, key by key.  The two packages share the pytree layout, so
weight norm stays as (v, g) pairs; ``nn.core.materialize_weight_norm``
folds them when wanted."""

from __future__ import annotations

import numpy as np
import torch


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def from_jax(params_np, state_np, device=None):
    """(params, state) of the port from the JAX package's numpy pytrees.
    The JAX state's frozen ``match_feature_network`` copy is training-only
    and is dropped."""
    params = _tree_to_torch(params_np, device)
    state = {"reg_network": _tree_to_torch(state_np["reg_network"], device)}
    return params, state
