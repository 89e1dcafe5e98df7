"""Where one training or finetune step spends its time on the card.

    python -m surf_tpu_torch.profile_train [--mode train|finetune] [--conf <conf>]
        [--out exp/profile_train]

``--mode train`` (default conf confs/surf_synthetic_full.conf) builds a
``Trainer``; ``--mode finetune`` (default conf
confs/surf_synthetic_finetune.conf) a ``Finetuner``, whose
``init_volumes`` runs the cascade over the scene's views.  Both start
from seeded random weights.  Two steps run first (cold, then warm), then
a third under ``torch.profiler`` (CPU and CUDA activities), cut into the
ranges ``forward`` (the loss: cascade and render in training, render
and pseudo points in finetune), ``backward`` and ``update``, each ending
in a synchronise.  Prints the card (nvidia-smi name and power limit), the
step's busy share (the union of the device operations' intervals over
its wall time), for each range and each span inside the forward
(``train.fpn``, ``train.cascade``, ``train.render``, ``train.loss``;
``finetune.render``, ``finetune.loss``) its host time, the device time
of the operations that start in it, its busy share and its heaviest
operations, and the device operations of the step by time (all of them
in ``<out>/kernels.txt``; ``profile_validate.report``).
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .card import nvidia_smi_line, set_numerics
from .config import ConfigFactory
from .finetune import Finetuner
from .profile_validate import report
from .train import Trainer
from .validate import to_device

PHASES = ("forward", "backward", "update")
CONFS = {"train": "confs/surf_synthetic_full.conf",
         "finetune": "confs/surf_synthetic_finetune.conf"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", choices=sorted(CONFS))
    p.add_argument("--conf", default=None, help="default: the mode's synthetic conf")
    p.add_argument("--out", default="exp/profile_train")
    return p.parse_args(argv)


def _trainer(conf, out):
    """(batch_fn(i), step_fn(batch, i), loss_fn(batch, i), runner) of a Trainer."""
    t = Trainer(conf, device="cuda", base_exp_dir=os.path.join(out, "train"))
    n = len(t.dataset)

    def loss(batch, i):
        res, new_state = t.loss(batch, i / n, t.cos_anneal_ratio(i / n))
        t.state = new_state
        return res
    return (lambda i: to_device(t.dataset[i], "cuda"), lambda b, i: t.step(b, i / n),
            loss, t)


def _finetuner(conf, out):
    f = Finetuner(conf, device="cuda", base_exp_dir=os.path.join(out, "finetune"))
    return f.next_batch, f.step, f.loss, f


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    set_numerics()
    smi = nvidia_smi_line()
    print(f"[device] {smi}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    conf = ConfigFactory.parse_file(args.conf or CONFS[args.mode])
    t0 = time.time()
    batch_fn, step_fn, loss_fn, runner = (_trainer if args.mode == "train"
                                          else _finetuner)(conf, args.out)
    torch.cuda.synchronize()
    print(f"[setup] {args.mode}: {time.time() - t0:.4f} s", flush=True)
    for i in range(2):                                     # cold, then warm
        t0 = time.time()
        step_fn(batch_fn(i), i)
        torch.cuda.synchronize()
        print(f"[step {i}] {time.time() - t0:.4f} s", flush=True)

    batch = batch_fn(2)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            res = loss_fn(batch, 2)
            torch.cuda.synchronize()
        with record_function("backward"):
            res["loss"].backward()
            torch.cuda.synchronize()
        with record_function("update"):
            runner.update()
            torch.cuda.synchronize()
    report(prof, PHASES, time.time() - t0, args.out, smi)


if __name__ == "__main__":
    main()
