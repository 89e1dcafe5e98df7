"""Parameter intake from the JAX package: ``from_jax(params_np, state_np)``
turns its parameter and state pytrees, given as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), into the port's pytrees of
torch tensors, key by key.  The two packages share the pytree layout, so
weight norm stays as (v, g) pairs; ``nn.core.materialize_weight_norm``
folds them when wanted."""

from __future__ import annotations

from .utils.checkpoint import to_torch_tree


def from_jax(params_np, state_np, device=None):
    """(params, state) of the port from the JAX package's numpy pytrees,
    the state's batch-norm statistics and frozen ``match_feature_network``
    copy included."""
    return to_torch_tree(params_np, device), to_torch_tree(state_np, device)
