"""Host-side datasets (numpy): ``DTUDataset``, the per-scene finetune
surfaces ``DTUDatasetFinetune`` and ``DTUDatasetFinetuneNeuS``, and the
procedural ``SyntheticDataset`` / ``SyntheticDatasetFinetune``, which need
no download (``dtu_scene.write_dtu_scene``, a fixture of the tests and of
``chip_smoke.py``, writes that scene as a DTU scan).  In mode ``finetune`` the bare dataset is the loader (its
``get_random_rays`` draws the batches)."""

import numpy as np

from .dtu import DTUDataset
from .finetune import (DTUDatasetFinetune, DTUDatasetFinetuneNeuS,
                       SyntheticDatasetFinetune)
from .synthetic import SyntheticDataset

_DATASETS = {"DTUDataset": DTUDataset,
             "SyntheticDataset": SyntheticDataset,
             "SyntheticDatasetFinetune": SyntheticDatasetFinetune,
             "DTUDatasetFinetune": DTUDatasetFinetune,
             "DTUDatasetFinetuneNeuS": DTUDatasetFinetuneNeuS}
# datasets that draw from the host generator get_dataset hands them
_SEEDED = (DTUDataset,)
# the JPEG layouts of surf_tpu/data/mvs_generic.py (GenericMVSDataset)
_JPEG = ("BMVSDataset", "TanksDataset", "ETH3DDataset")


def get_dataset(conf, mode, seed=0):
    """The dataset ``conf["dataset_name"]`` in ``mode``.  A dataset that
    draws rays and views on the host gets ``np.random.RandomState(seed)``,
    as the JAX package's ``get_loader`` gives it."""
    name = conf["dataset_name"]
    if name in _JPEG:
        raise NotImplementedError(
            f"{name} is not ported yet: its images are JPEG, and the port has no "
            "JPEG decoder yet (ROADMAP.md, queue 1: the JPEG decoder and "
            "GenericMVSDataset)")
    if name not in _DATASETS:
        raise NotImplementedError(f"dataset {name} is not ported yet")
    cls = _DATASETS[name]
    if cls in _SEEDED:
        return cls(conf, mode, rng=np.random.RandomState(seed))
    return cls(conf, mode)


__all__ = ["DTUDataset", "DTUDatasetFinetune", "DTUDatasetFinetuneNeuS",
           "SyntheticDataset", "SyntheticDatasetFinetune", "get_dataset"]
