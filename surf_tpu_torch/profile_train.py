"""Where one training step spends its time on the card.

    python -m surf_tpu_torch.profile_train [--conf confs/surf_synthetic_full.conf]
        [--out exp/profile_train]

Builds a ``Trainer`` on seeded random weights and runs two steps (cold,
then warm), then a third under ``torch.profiler`` (CPU and CUDA
activities), cut into the ranges ``forward`` (cascade, render, loss),
``backward`` and ``update``, each ending in a synchronise.  Prints the
card (nvidia-smi name and power limit), the step's busy share, each
range's host time, the device time of the kernels that start in it and
their heaviest kernels, and the CUDA kernels of the step by device time
(all of them in ``<out>/kernels.txt``).  Needs a card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .card import nvidia_smi_line, set_numerics
from .config import ConfigFactory
from .profile_validate import report
from .train import Trainer
from .validate import to_device

PHASES = ("forward", "backward", "update")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conf", default="confs/surf_synthetic_full.conf")
    p.add_argument("--out", default="exp/profile_train")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    set_numerics()
    smi = nvidia_smi_line()
    print(f"[device] {smi}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    t = Trainer(ConfigFactory.parse_file(args.conf), device="cuda",
                base_exp_dir=os.path.join(args.out, "train"))
    n = len(t.dataset)
    for i in range(2):                                     # cold, then warm
        t0 = time.time()
        t.step(to_device(t.dataset[i], "cuda"), i / n)
        torch.cuda.synchronize()
        print(f"[step {i}] {time.time() - t0:.4f} s", flush=True)

    batch = to_device(t.dataset[2], "cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            res, new_state = t.loss(batch, 2 / n, t.cos_anneal_ratio(2 / n))
            torch.cuda.synchronize()
        with record_function("backward"):
            res["loss"].backward()
            torch.cuda.synchronize()
        with record_function("update"):
            t.update()
            torch.cuda.synchronize()
    t.state = new_state
    report(prof, PHASES, time.time() - t0, args.out, smi)


if __name__ == "__main__":
    main()
