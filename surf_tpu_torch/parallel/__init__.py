"""Multi-process training and validation over ``torch.distributed``: one
process a card (the counterpart of surf_tpu/parallel/)."""

from .distribute import (detect_multiprocess_env, is_main_process, maybe_initialize,
                         process_count, process_index)
from .mesh import dp_train_step, process_slice
from .ray_shard import ray_group

__all__ = ["detect_multiprocess_env", "dp_train_step", "is_main_process",
           "maybe_initialize", "process_count", "process_index", "process_slice",
           "ray_group"]
