"""Training: the counterpart of ``Runner.train``, ``_label_fn`` and
``_make_optimizer`` (surf_tpu/runner.py:212-230, 310-407).

Per step: ``surf.forward(..., training)`` over the batch's rays (the
cascade, the render with grad and H.1 kept in the graph, the patch warp
and the pseudo-point SDF), ``losses.compute_loss`` and one
``loss.backward()``, which runs the backward kernels K1b, K2b, K3b and
K4w (and K4 on the transposed tables).  The optimizer is two Adam groups
-- ``mlp`` (the implicit surface) at ``mlp_lr`` and ``feat`` (everything
else) at ``feat_lr`` -- under a ``LambdaLR`` of ``warmup_cosine(step /
steps_per_epoch)``, stepped after the update, as optax sees the count
before its increment.  Weight norm stays (v, g) in the parameters and is
folded inside the differentiated forward.  The batch-norm running
statistics and the frozen ``match_feature_network`` are state, never
optimized; the latter is refreshed on even epochs.  A checkpoint
(``model``, ``state``, ``epoch``; the JAX package's npz layout) is saved
every ``save_freq`` epochs.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .data import get_dataset
from .losses import compute_loss, make_loss_config
from .nn import surf
from .nn.core import tree_leaves
from .utils import save_checkpoint, to_numpy_tree, warmup_cosine
from .validate import to_device


class Trainer:
    def __init__(self, conf, *, device="cuda", seed=0, base_exp_dir=None,
                 params=None, state=None):
        self.conf = conf
        self.device = torch.device(device)
        self.epochs = conf.get_int("train.epochs")
        self.save_freq = conf.get_float("train.save_freq")
        self.log_freq = conf.get_float("train.log_freq", default=1.0)
        self.anneal_end = conf.get_float("train.anneal_end", default=0.0)
        self.base_exp_dir = base_exp_dir or os.path.join(
            conf["general.base_exp_dir"], "torch")
        self.seed = seed
        self.dataset = get_dataset(conf["train_dataset"], "train")
        self.params, self.state, self.static = surf.init(
            conf["model"], seed=seed, device=self.device)
        if params is not None:
            self.params, self.state = params, state
        for t in tree_leaves(self.params):
            t.requires_grad_(True)
        self.loss_cfg = make_loss_config(conf["train.loss"])
        self.steps_per_epoch = max(len(self.dataset), 1)
        self.lr_scale = warmup_cosine(self.epochs, conf.get_float("train.warmup"),
                                      conf.get_float("train.alpha"))
        lr = conf["train.lr_conf"]
        mlp_lr = float(lr["mlp_lr"])
        feat_lr = float(lr.get("feat_lr", mlp_lr))
        mlp = tree_leaves(self.params["implicit_surface"])
        feat = [t for k, v in self.params.items() if k != "implicit_surface"
                for t in tree_leaves(v)]
        self.optimizer = torch.optim.Adam(
            [{"params": mlp, "lr": mlp_lr, "name": "mlp"},
             {"params": feat, "lr": feat_lr, "name": "feat"}],
            betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: self.lr_scale(k / self.steps_per_epoch))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.active_voxels = None

    def cos_anneal_ratio(self, step_f):
        return 1.0 if self.anneal_end == 0.0 else min(1.0, step_f / self.anneal_end)

    def loss(self, batch, step_f, anneal, *, perturb=True, pts_random=None):
        """Forward and loss terms of one batch (tensors on the device).
        Returns (terms, new_state)."""
        outputs, new_state = surf.forward(
            self.params, self.state, self.static, batch, cos_anneal_ratio=anneal,
            step=step_f, perturb=perturb, generator=self.generator,
            pts_random=pts_random)
        res = compute_loss(self.loss_cfg, outputs, batch, step_f, "train")
        res["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(torch.mean(
            (outputs["color_fine"] - batch["color"]) ** 2)))
        self.active_voxels = outputs["active_voxels"]
        return res, new_state

    def update(self):
        """One Adam step of both groups at the scheduled LRs, then the
        schedule moves on."""
        self.optimizer.step()
        self.scheduler.step()

    def step(self, batch, step_f):
        """One training step; returns the loss terms as floats."""
        self.optimizer.zero_grad(set_to_none=True)
        res, new_state = self.loss(batch, step_f, self.cos_anneal_ratio(step_f))
        res["loss"].backward()
        self.update()
        self.state = new_state
        return {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                for k, v in res.items()}

    def train(self):
        n = len(self.dataset)
        for epoch in range(self.epochs):
            if epoch % 2 == 0:
                self.state = surf.refresh_match_features(self.params, self.state)
            order = np.arange(n)
            np.random.RandomState(self.seed + epoch).shuffle(order)
            t0 = time.time()
            for i, idx in enumerate(order):
                step_f = epoch + i / n
                batch = to_device(self.dataset[int(idx)], self.device)
                res = self.step(batch, step_f)
                if (epoch * n + i) % max(int(self.log_freq * n), 1) == 0:
                    print(f"[epoch {epoch} {i}/{n}] loss {res['loss']:.4f} color "
                          f"{res['color_loss']:.4f} psnr {res['psnr']:.2f} "
                          f"({(time.time() - t0) / (i + 1):.2f}s/it)", flush=True)
                if not math.isfinite(res["loss"]):
                    raise FloatingPointError(f"non-finite loss at epoch {epoch} step {i}")
            if (epoch + 1) % self.save_freq == 0 or epoch + 1 >= self.epochs:
                self.save(epoch)

    def save(self, epoch):
        path = os.path.join(self.base_exp_dir, "checkpoints",
                            f"model_{epoch:0>3}.ckpt.npz")
        save_checkpoint(path, {"epoch": epoch, "model": to_numpy_tree(self.params),
                               "state": to_numpy_tree(self.state)})
        return path
