"""Host-side datasets (numpy).  The procedural ``SyntheticDataset`` and its
per-scene finetune surface ``SyntheticDatasetFinetune``; DTU and the
other loaders come with the data.  In mode ``finetune`` the bare dataset
is the loader (its ``get_random_rays`` draws the batches)."""

from .finetune import (DTUDatasetFinetune, DTUDatasetFinetuneNeuS,
                       SyntheticDatasetFinetune)
from .synthetic import SyntheticDataset

_DATASETS = {"SyntheticDataset": SyntheticDataset,
             "SyntheticDatasetFinetune": SyntheticDatasetFinetune,
             "DTUDatasetFinetune": DTUDatasetFinetune,
             "DTUDatasetFinetuneNeuS": DTUDatasetFinetuneNeuS}


def get_dataset(conf, mode):
    name = conf["dataset_name"]
    if name not in _DATASETS:
        raise NotImplementedError(f"dataset {name} is not ported yet")
    return _DATASETS[name](conf, mode)


__all__ = ["SyntheticDataset", "SyntheticDatasetFinetune", "get_dataset"]
