"""The conf derivation behind scripts/torch_finetune_runs.sh's stage C
(``surf_tpu_torch.derive_conf``) and the HOCON writer it uses
(``config.dump_string``), on the host:

* every shipped conf (confs/*.conf) written by ``dump_string`` reads back
  through the port's parser to the tree it was, which is also the tree the
  JAX package's parser reads from the shipped file;
* stage C's derivation of each finetune conf through the CLI changes its
  four keys and nothing else;
* a key the shipped conf lacks, a key that names a block, and an argument
  without ``=`` raise, and write no file.
"""

import glob
import os

import pytest

from surf_tpu.config import ConfigFactory as JConfigFactory
from surf_tpu_torch import derive_conf
from surf_tpu_torch.config import (ConfigMissingException, dump_string, parse_file,
                                   parse_string)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "confs", "*.conf")))
STAGE_C = {"train.epochs": 60, "train.val_before_finetune": False, "train.val_freq": 60,
           "train.save_freq": 60}


def _plain(tree):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in tree.items()}


def test_the_shipped_confs_are_all_read():
    assert "surf_synthetic_finetune.conf" in CONFS and len(CONFS) >= 9


@pytest.mark.parametrize("name", CONFS)
def test_written_conf_reads_back_equal(name):
    path = os.path.join(ROOT, "confs", name)
    conf = parse_file(path)
    back = parse_string(dump_string(conf))
    assert _plain(back) == _plain(conf)
    assert _plain(back) == _plain(JConfigFactory.parse_file(path))


@pytest.mark.parametrize("name", ["surf_synthetic_finetune.conf",
                                  "surf_synthetic_finetune_mid.conf"])
def test_stage_c_derivation_sets_its_keys_only(name, tmp_path):
    src = os.path.join(ROOT, "confs", name)
    out = tmp_path / "C.conf"
    derive_conf.main([src, str(out)] + [f"{k}={str(v).lower()}" for k, v in STAGE_C.items()])
    got, want = parse_file(str(out)), parse_file(src)
    assert want.get_int("train.epochs") > 60 and want.get_bool("train.val_before_finetune")
    for k, v in STAGE_C.items():
        assert got[k] == v and type(got[k]) is type(v), k
        want[k] = v
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("assignment,error", [
    ("train.epoch=60", ConfigMissingException),
    ("finetune_dataset.n_ray=64", ConfigMissingException),
    ("train.loss=1", ValueError),
    ("train.epochs", ValueError)])
def test_derivation_refuses_what_the_conf_lacks(assignment, error, tmp_path):
    out = tmp_path / "C.conf"
    with pytest.raises(error):
        derive_conf.main([os.path.join(ROOT, "confs", "surf_synthetic_finetune.conf"),
                          str(out), "train.val_freq=60", assignment])
    assert not out.exists()
