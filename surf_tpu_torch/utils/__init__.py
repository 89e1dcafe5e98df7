"""Training utilities: the LR schedule and the npz checkpoint layout."""

from .checkpoint import save_checkpoint, load_checkpoint, to_numpy_tree, to_torch_tree
from .scheduler import warmup_cosine

__all__ = ["save_checkpoint", "load_checkpoint", "to_numpy_tree", "to_torch_tree",
           "warmup_cosine"]
