"""Validation metrics inside and outside the scene's mask, before training
and at each of the trainer's validates:

    python -m surf_tpu_torch.val_after_train --conf confs/surf_synthetic_full.conf
        [--device cuda|cpu] [--out <dir>]

The conf trains as ``python -m surf_tpu_torch.main --conf <conf>`` trains
it.  Each measurement builds every validation scene's cascade and renders
its view as the validate does, then prints one JSON line a scene: the
PSNR over the view, inside the reference view's mask and outside it, the
mask's share of the view, and the render and SDF depth errors inside the
mask (the SDF's where it found a surface), all at the rendered pixels.
It measures the conf's ``val_dataset`` with each of its and the
``train_dataset``'s numbers of source views and image sizes (``"val":
"src<n>_<h>x<w>"``): the val conf's own pair is what ``val_img_avg``
records, the training's pair shows the same scenes as training sees
them, and the two crossed pairs say which of the two moves the metrics.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .card import set_numerics
from .config import ConfigFactory
from .train import Trainer
from .validate import Validator, to_device


def psnr(a, b):
    return float(20.0 * np.log10(1.0 / max(np.sqrt(((a - b) ** 2).mean()), 1e-10)))


def view_metrics(inputs, color, sdf_depth, render_depth):
    """A validation item's rendered view against its ground truth, at the
    rendered pixels (``pixels_x``, ``pixels_y``)."""
    px = np.asarray(inputs["pixels_x"]).astype(np.int64)
    py = np.asarray(inputs["pixels_y"]).astype(np.int64)
    inside = np.asarray(inputs["masks"])[0][py, px] > 0.5
    depth = np.asarray(inputs["depth_ref"])[py, px]
    gt, color = np.asarray(inputs["color"]), np.asarray(color).reshape(-1, 3)
    rd, sd = np.asarray(render_depth).reshape(-1), np.asarray(sdf_depth).reshape(-1)
    found = inside & (sd > 0)
    return {"scene": inputs["scene"], "psnr": psnr(color, gt),
            "psnr_in_mask": psnr(color[inside], gt[inside]),
            "psnr_out_of_mask": psnr(color[~inside], gt[~inside]),
            "mask_share": float(inside.mean()),
            "render_depth_in_mask": float(np.abs(rd - depth)[inside].mean()),
            "sdf_depth_in_mask": float(np.abs(sd - depth)[found].mean()),
            "sdf_found_share": float(found.sum() / inside.sum())}


@torch.no_grad()
def scene_metrics(v):
    """``view_metrics`` of each of ``v``'s validation scenes on its
    current parameters and state, built and rendered as the validate does."""
    out = []
    for idx in range(len(v.dataset)):
        inputs = v.dataset[idx]
        ipts = to_device(inputs, v.device)
        _, stages, matching, features = v.build(ipts)
        color, _, sdf_depth, render_depth = v.render_full_image(
            ipts, stages[::-1], matching, features[::-1])
        out.append(view_metrics(inputs, color, sdf_depth, render_depth))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conf", type=str, default="./confs/surf_synthetic_full.conf")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", type=str, default="./exp/val_after_train")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    set_numerics()
    conf = ConfigFactory.parse_file(args.conf)
    trainer = Trainer(conf, device=args.device, base_exp_dir=args.out)
    checks = {}
    for src in (conf["val_dataset.num_src_view"], conf["train_dataset.num_src_view"]):
        for hw in (conf["val_dataset.img_hw"], conf["train_dataset.img_hw"]):
            name = f"src{src}_{hw[0]}x{hw[1]}"
            c = ConfigFactory.parse_file(args.conf)
            c["val_dataset"]["num_src_view"], c["val_dataset"]["img_hw"] = src, hw
            checks[name] = Validator(c, device=args.device,
                                     base_exp_dir=os.path.join(args.out, name))
    rows = []

    def measure(when):
        for name, v in checks.items():
            v.params, v.state = trainer.params, trainer.state
            for m in scene_metrics(v):
                rows.append({"when": when, "val": name, **m})
                print("[val_after_train] " + json.dumps(rows[-1]), flush=True)

    validate = trainer.validate

    def validate_and_measure(val, epoch):
        res = validate(val, epoch)
        measure(f"epoch {epoch}")
        return res
    trainer.validate = validate_and_measure
    measure("untrained")
    trainer.train()
    return rows


if __name__ == "__main__":
    main()
