"""Host-side datasets (numpy): ``DTUDataset``, the per-scene finetune
surfaces ``DTUDatasetFinetune`` and ``DTUDatasetFinetuneNeuS``, the JPEG
validation sets ``BMVSDataset``, ``TanksDataset`` and ``ETH3DDataset``
(``mvs_generic.GenericMVSDataset``), and the procedural
``SyntheticDataset`` / ``SyntheticDatasetFinetune``, which need no
download (``dtu_scene.write_dtu_scene`` and ``mvs_scene.write_mvs_scene``,
fixtures of the tests, write that scene as a DTU
scan and in the three JPEG layouts).  In mode ``finetune`` the bare
dataset is the loader (its ``get_random_rays`` draws the batches)."""

import numpy as np

from .dtu import DTUDataset
from .finetune import (DTUDatasetFinetune, DTUDatasetFinetuneNeuS,
                       SyntheticDatasetFinetune)
from .mvs_generic import BMVSDataset, ETH3DDataset, TanksDataset
from .synthetic import SyntheticDataset

_DATASETS = {"DTUDataset": DTUDataset,
             "SyntheticDataset": SyntheticDataset,
             "SyntheticDatasetFinetune": SyntheticDatasetFinetune,
             "DTUDatasetFinetune": DTUDatasetFinetune,
             "DTUDatasetFinetuneNeuS": DTUDatasetFinetuneNeuS,
             "BMVSDataset": BMVSDataset,
             "TanksDataset": TanksDataset,
             "ETH3DDataset": ETH3DDataset}
# datasets that draw from the host generator get_dataset hands them
_SEEDED = (DTUDataset, BMVSDataset, TanksDataset, ETH3DDataset)


def get_dataset(conf, mode, seed=0):
    """The dataset ``conf["dataset_name"]`` in ``mode``.  A dataset that
    draws rays and views on the host gets ``np.random.RandomState(seed)``,
    as the JAX package's ``get_loader`` gives it."""
    name = conf["dataset_name"]
    if name not in _DATASETS:
        raise NotImplementedError(f"dataset {name} is not ported yet")
    cls = _DATASETS[name]
    if cls in _SEEDED:
        return cls(conf, mode, rng=np.random.RandomState(seed))
    return cls(conf, mode)


__all__ = ["BMVSDataset", "DTUDataset", "DTUDatasetFinetune", "DTUDatasetFinetuneNeuS",
           "ETH3DDataset", "SyntheticDataset", "SyntheticDatasetFinetune", "TanksDataset",
           "get_dataset"]
