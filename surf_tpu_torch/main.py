"""CLI of the port, with the JAX CLI's flags (main.py):

    python -m surf_tpu_torch.main --conf confs/surf.conf [--mode train|val]
        [--resume <npz>] [--load_vol] [--clean_mesh] [--mesh_resolution 512] [--seed 0]
    python -m surf_tpu_torch.main --conf confs/surf_finetune.conf --mode finetune
        --resume <npz> [--load_vol] [--scene <name>] [--ref_view <i>]

``--resume`` loads a model checkpoint (``model`` and ``state``), or with
``--load_vol`` a finetune checkpoint's volumes and implicit surface; in
train mode it also restores the optimizer's state and goes on from the
epoch after the saved one (a checkpoint of either package).
``--clean_mesh`` cleans each validation mesh against the item's dilated
masks and the views' frusta before it is written (off by default).
Finetune writes under ``<out>/<scene>/view<ref_view>``.  Runs on the card
unless ``--device cpu``.

As the JAX runner does, the first rank copies the repository into
``<out>/codes_recording`` once before the run, and the loops write
TensorBoard scalars into ``<out>/logs``.  With ``train.profile_dir`` in
the conf, a ``torch.profiler`` trace of the run (from the trainer's,
finetuner's or validator's construction to the end of the run) is written
into that directory as a Chrome trace; ``train.debug_nans`` stops training
and finetune at the first non-finite loss term.

Multi-device (train and val), one process a card:

    torchrun --nproc_per_node N -m surf_tpu_torch.main --mode train|val ...

(or under SLURM); the process group is joined (``--dist_url``, default
``env://``) before any device use, each rank on ``cuda:<local rank %
cards>``, and ``parallel.distribute`` prints the backend it chose.
``--mode finetune`` runs in one process."""

from __future__ import annotations

import argparse
import json

import torch

from .card import set_numerics
from .config import ConfigFactory
from .finetune import Finetuner
from .parallel.distribute import (detect_multiprocess_env, is_main_process,
                                  local_rank_and_size, maybe_initialize, rank_device)
from .train import Trainer
from .utils import resume_from
from .utils.experiment import codes_backup, profile_trace
from .validate import Validator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="surf_tpu_torch")
    p.add_argument("--conf", type=str, default="./confs/surf.conf")
    p.add_argument("--mode", type=str, default="train", choices=["train", "val", "finetune"])
    p.add_argument("--resume", type=str, default=None, help="checkpoint path to resume")
    p.add_argument("--load_vol", action="store_true",
                   help="resume from a volume-only finetune checkpoint")
    p.add_argument("--scene", type=str, default=None, help="finetune scene override")
    p.add_argument("--ref_view", type=int, default=None,
                   help="finetune reference view override")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--clean_mesh", action="store_true",
                   help="clean validation meshes with the masks and view frusta")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", type=str, default=None,
                   help="output directory (default <base_exp_dir>/torch)")
    p.add_argument("--dist_url", type=str, default="env://",
                   help="rendezvous of a multi-process run (env:// or file://<path>)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    set_numerics()
    conf = ConfigFactory.parse_file(args.conf)
    if args.mode == "finetune":
        if (detect_multiprocess_env() or {}).get("world_size", 1) > 1:
            raise SystemExit("--mode finetune runs in one process")
    elif maybe_initialize(conf, device=args.device, init_method=args.dist_url):
        args.device = rank_device(args.device)
    if args.mode == "finetune" and args.resume is None:
        raise SystemExit("--mode finetune needs --resume <checkpoint>")
    with profile_trace(conf.get_string("train.profile_dir", default=None), args.device):
        return run(args, conf)


def run(args, conf):
    """Build the mode's trainer, finetuner or validator, back the code up
    into its directory (first rank) and run it."""
    if args.mode == "train":
        t = Trainer(conf, device=args.device, seed=args.seed, base_exp_dir=args.out,
                    mesh_resolution=args.mesh_resolution, resume=args.resume,
                    clean_mesh=args.clean_mesh)
        backup(t.base_exp_dir)
        t.train()
        return t
    if args.mode == "finetune":
        f = Finetuner(conf, device=args.device, seed=args.seed, base_exp_dir=args.out,
                      scene=args.scene, ref_view=args.ref_view, resume=args.resume,
                      load_vol=args.load_vol, mesh_resolution=args.mesh_resolution)
        backup(f.base_exp_dir)
        f.finetune()
        return f
    v = Validator(conf, device=args.device, mesh_resolution=args.mesh_resolution,
                  seed=args.seed, base_exp_dir=args.out, clean_mesh=args.clean_mesh)
    backup(v.base_exp_dir)
    if args.resume is not None:
        v.params, v.state, v.vol_state = resume_from(
            args.resume, v.params, v.state, load_vol=args.load_vol, device=v.device)
    results = v.validate()
    if local_rank_and_size()[0] == 0:
        print(json.dumps(results))
    return results


def backup(base_exp_dir):
    if is_main_process():
        codes_backup(base_exp_dir)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        # leave once every rank is done
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
