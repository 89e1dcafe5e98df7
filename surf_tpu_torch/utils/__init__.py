"""Training utilities: the LR schedule, the npz checkpoint layout and the
host-side helpers."""

from .checkpoint import (save_checkpoint, load_checkpoint, to_numpy_tree, to_torch_tree,
                         vol_state_tree, vol_state_from_tree, resume_from)
from .scheduler import warmup_cosine
from .tools import to_device, tensor2float, save_scalars, DictAverageMeter, setup_seed

__all__ = ["save_checkpoint", "load_checkpoint", "to_numpy_tree", "to_torch_tree",
           "vol_state_tree", "vol_state_from_tree", "resume_from",
           "warmup_cosine", "to_device", "tensor2float", "save_scalars",
           "DictAverageMeter", "setup_seed"]
