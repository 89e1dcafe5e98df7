"""Host-side datasets (numpy).  This slice carries the procedural
``SyntheticDataset`` only; DTU and the other loaders come with the data."""

from .synthetic import SyntheticDataset

_DATASETS = {"SyntheticDataset": SyntheticDataset}


def get_dataset(conf, mode):
    name = conf["dataset_name"]
    if name not in _DATASETS:
        raise NotImplementedError(f"dataset {name} is not ported yet")
    return _DATASETS[name](conf, mode)


__all__ = ["SyntheticDataset", "get_dataset"]
