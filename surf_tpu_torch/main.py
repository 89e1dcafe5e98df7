"""CLI of the port: ``python -m surf_tpu_torch.main --conf
confs/surf_synthetic_full.conf --mode val|train [--mesh_resolution 512]
[--device cuda|cpu]``.  Runs on the card unless ``--device cpu``."""

from __future__ import annotations

import argparse
import json

import torch

from .card import set_numerics
from .config import ConfigFactory
from .train import Trainer
from .validate import Validator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="surf_tpu_torch")
    p.add_argument("--conf", type=str, default="./confs/surf.conf")
    p.add_argument("--mode", type=str, default="val", choices=["val", "train"])
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", type=str, default=None,
                   help="output directory (default <base_exp_dir>/torch)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    set_numerics()
    conf = ConfigFactory.parse_file(args.conf)
    if args.mode == "train":
        t = Trainer(conf, device=args.device, base_exp_dir=args.out)
        t.train()
        return None
    v = Validator(conf, device=args.device, mesh_resolution=args.mesh_resolution,
                  base_exp_dir=args.out)
    results = v.validate()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
