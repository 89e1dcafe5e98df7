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
(``model``, ``state``, ``epoch``, and the optimizer's ``opt_state`` and
``opt_struct``: the JAX package's npz layout, ``utils/opt_state.py``) is
saved every ``save_freq`` epochs; ``resume`` (``--mode train --resume``)
restores parameters, state and, where the checkpoint holds them, the Adam
moments, step counts and schedule position, and training goes on from the
epoch after the saved one.  After the save, every ``val_freq`` epochs
the validation scenes go through the port's validate path (a
``Validator`` on the trained parameters and batch-norm state, under
``torch.no_grad``), which writes the mesh and the ``val_*`` files.  Each
epoch's loss terms are averaged and printed with the median step's
seconds (a step from its forward until the card has run its update, the
item's load outside it) and, on the card, the peak memory so far; a
last ``[train]`` line gives the run's first step and the median, least
and most of the others.  As the JAX runner does, the first rank writes
TensorBoard scalars under ``<base_exp_dir>/logs`` (``utils.summary``):
the terms as ``train/<term>`` at the global step
every ``log_freq`` of an epoch, their epoch means as ``train_avg/<term>``
at the epoch, and the validation's ``val_img_avg``.  With
``train.debug_nans`` the loop runs under autograd's anomaly mode with
its NaN check and raises ``FloatingPointError`` at the first non-finite
loss term, before its backward (the exception ``jax_debug_nans``
raises); without it, nothing is checked.

Under ``torch.distributed`` with more than one rank the loop is the JAX
runner's data-parallel one (surf_tpu/runner.py:316-372; there
``train.data_parallel``, default true, must not be false): one item a
rank a step through ``parallel.mesh.dp_train_step``, the epoch's last
super-batch padded at weight 0, rank 0's parameters broadcast at
start-up; rank r's generator is seeded ``rank_seed(seed, r)``.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from .data import get_dataset
from .losses import compute_loss, make_loss_config
from .nn import surf
from .nn.core import tree_leaves
from .parallel import mesh as dp
from .parallel.distribute import is_main_process, process_count, process_index
from .utils import load_checkpoint, save_checkpoint, to_numpy_tree, to_torch_tree, \
    warmup_cosine
from .utils.opt_state import fingerprint, opt_state_tree, restore_opt_state
from .utils.spans import span
from .utils.summary import mean_scalars, save_scalars, scalar_writer
from .validate import Validator, to_device


def check_finite(terms, where):
    """``FloatingPointError`` naming the first non-finite entry of
    ``terms`` (loss terms, tensors or floats)."""
    for k, v in terms.items():
        x = float(v.detach()) if torch.is_tensor(v) else float(v)
        if not math.isfinite(x):
            raise FloatingPointError(f"train.debug_nans: non-finite {k} ({x}) at {where}")


def anomaly_mode(debug_nans):
    """Autograd's anomaly mode with its NaN check when ``debug_nans``, else
    nothing changes."""
    if debug_nans:
        return torch.autograd.set_detect_anomaly(True, check_nan=True)
    return contextlib.nullcontext()


def rank_seed(seed, rank):
    """The seed of rank ``rank``'s generator: rank 0 draws what a single
    process draws (``seed + 1``), the others their own streams."""
    return seed + 1 + 1_000_003 * rank


class Trainer:
    def __init__(self, conf, *, device="cuda", seed=0, base_exp_dir=None,
                 params=None, state=None, mesh_resolution=512, resume=None,
                 clean_mesh=False):
        """``resume``: a training checkpoint of either package (else
        ``params`` / ``state``, or the seeded init).  More than one rank
        trains data-parallel; ``train.data_parallel = false`` is refused
        there (each rank would train its own replica, and the validate's
        ray groups would mix their parameters)."""
        self.world, self.rank = process_count(), process_index()
        if self.world > 1 and not conf.get_bool("train.data_parallel", default=True):
            raise SystemExit(f"training on {self.world} ranks needs train.data_parallel = "
                             "true (the conf sets it false)")
        self.data_parallel = self.world > 1
        self.conf = conf
        self.device = torch.device(device)
        self.epochs = conf.get_int("train.epochs")
        self.save_freq = conf.get_float("train.save_freq")
        self.log_freq = conf.get_float("train.log_freq", default=1.0)
        self.val_freq = conf.get_float("train.val_freq")
        self.mesh_resolution = mesh_resolution
        self.clean_mesh = clean_mesh
        self.anneal_end = conf.get_float("train.anneal_end", default=0.0)
        self.debug_nans = conf.get_bool("train.debug_nans", default=False)
        self.base_exp_dir = base_exp_dir or os.path.join(
            conf["general.base_exp_dir"], "torch")
        self.writer = scalar_writer(os.path.join(self.base_exp_dir, "logs"))
        self.seed = seed
        self.dataset = get_dataset(conf["train_dataset"], "train", seed=seed)
        self.params, self.state, self.static = surf.init(
            conf["model"], seed=seed, device=self.device)
        if params is not None:
            self.params, self.state = params, state
        ckpt = load_checkpoint(resume) if resume is not None else None
        if ckpt is not None:
            self.params = to_torch_tree(ckpt["model"], self.device)
            if "state" in ckpt:
                self.state = to_torch_tree(ckpt["state"], self.device)
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
        self.generator.manual_seed(rank_seed(seed, self.rank))
        self.active_voxels = None
        self.start_epoch = 0
        if ckpt is not None and "opt_state" in ckpt:
            restore_opt_state(self.params, self.optimizer, self.scheduler,
                              ckpt["opt_state"], ckpt.get("opt_struct"))
            self.start_epoch = int(ckpt["epoch"]) + 1
        if self.data_parallel:
            # every rank starts from rank 0's parameters and state
            dp.broadcast_tree([self.params, self.state])

    def cos_anneal_ratio(self, step_f):
        return 1.0 if self.anneal_end == 0.0 else min(1.0, step_f / self.anneal_end)

    def loss(self, batch, step_f, anneal, *, perturb=True, pts_random=None):
        """Forward and loss terms of one batch (tensors on the device).
        Returns (terms, new_state)."""
        outputs, new_state = surf.forward(
            self.params, self.state, self.static, batch, cos_anneal_ratio=anneal,
            step=step_f, perturb=perturb, generator=self.generator,
            pts_random=pts_random)
        with span("train.loss"):
            res = compute_loss(self.loss_cfg, outputs, batch, step_f, "train")
            res["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(torch.mean(
                (outputs["color_fine"] - batch["color"]) ** 2)))
        self.active_voxels = outputs["active_voxels"]
        if self.debug_nans:
            check_finite(res, f"step {step_f}")
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

    def validate(self, validator, epoch):
        """The validation scenes on the current parameters and state."""
        validator.params, validator.state = self.params, self.state
        with torch.no_grad():
            return validator.validate(epoch)

    def train(self):
        """Epochs from ``start_epoch``.  Data-parallel, an epoch is
        ceil(N / ranks) super-batches of one item a rank from the same
        seeded order, the last padded with the last item at weight 0; the
        schedule counts super-batches (as the JAX runner's optax count
        does).  Rank 0 alone prints and saves; every rank validates."""
        with anomaly_mode(self.debug_nans):
            self._train()

    def _train(self):
        n_items = len(self.dataset)
        W = self.world if self.data_parallel else 1
        n = -(-n_items // W)
        main = is_main_process()
        val = None
        step_s = []
        for epoch in range(self.start_epoch, self.epochs):
            if epoch % 2 == 0:
                self.state = surf.refresh_match_features(self.params, self.state)
            order = np.arange(n_items)
            np.random.RandomState(self.seed + epoch).shuffle(order)
            t0 = time.time()
            rows = []
            for i in range(n):
                step_f = epoch + i / n
                if self.data_parallel:
                    # this rank's item of the super-batch, and every weight
                    picks = [i * W + r for r in range(W)]
                    weights = [1.0 if j < n_items else 0.0 for j in picks]
                    idx = order[min(picks[self.rank], n_items - 1)]
                    batch = to_device(self.dataset[int(idx)], self.device)
                    t_step = time.time()
                    res = dp.dp_train_step(self, batch, step_f, weights)
                else:
                    batch = to_device(self.dataset[int(order[i])], self.device)
                    t_step = time.time()
                    res = self.step(batch, step_f)
                # the clock stops once the card has run the step's update
                # (data-parallel, the update follows the terms' read)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                step_s.append(time.time() - t_step)
                rows.append(res)
                global_step = epoch * n + i
                if main and global_step % max(int(self.log_freq * n), 1) == 0:
                    save_scalars(self.writer, "train", res, global_step)
                    print(f"[epoch {epoch} {i}/{n}] loss {res['loss']:.4f} color "
                          f"{res['color_loss']:.4f} psnr {res['psnr']:.2f} "
                          f"({(time.time() - t0) / (i + 1):.2f}s/it)", flush=True)
            if main:
                avg = mean_scalars(rows)
                save_scalars(self.writer, "train_avg", avg, epoch)
                print(f"[epoch {epoch} train_avg] " + " ".join(
                    f"{k} {v:.4f}" for k, v in avg.items())
                    + f" s/step {np.median(step_s[-n:]):.3f}" + self._peak_mem(), flush=True)
                if (epoch + 1) % self.save_freq == 0 or epoch + 1 >= self.epochs:
                    self.save(epoch)
            if (epoch + 1) % self.val_freq == 0:
                val = val or Validator(self.conf, device=self.device,
                                       mesh_resolution=self.mesh_resolution, seed=self.seed,
                                       base_exp_dir=self.base_exp_dir,
                                       clean_mesh=self.clean_mesh, writer=self.writer)
                self.validate(val, epoch)

        if main and step_s:
            warm = step_s[1:] or step_s
            print(f"[train] {len(step_s)} steps: first {step_s[0]:.3f} s, then s/step median "
                  f"{np.median(warm):.3f} min {min(warm):.3f} max {max(warm):.3f}"
                  + self._peak_mem(), flush=True)

    def _peak_mem(self):
        """The card's peak allocated memory so far, for the printed lines."""
        if self.device.type != "cuda":
            return ""
        return f" peak_mem_gb {torch.cuda.max_memory_allocated(self.device) / 2 ** 30:.2f}"

    def save(self, epoch):
        path = os.path.join(self.base_exp_dir, "checkpoints",
                            f"model_{epoch:0>3}.ckpt.npz")
        save_checkpoint(path, {
            "epoch": epoch, "model": to_numpy_tree(self.params),
            "state": to_numpy_tree(self.state),
            "opt_state": opt_state_tree(self.params, self.optimizer, self.scheduler),
            "opt_struct": np.asarray(fingerprint(self.params))})
        return path
