"""SuRF's validate and training step over the plain copies beside this
file (surf_tpu_torch/validate.py and train.py, commit 5b1d451).

The random draws are the callers': a render gets the state its
generator had before the program's render of the same view, a training
step the state before the program's step, and each draws from it in the
program's order."""

from __future__ import annotations

import numpy as np
import torch

from ..conf import Conf
from .losses.loss import compute_loss, make_loss_config
from .nn import feature_net, implicit_surface, sdf_net, surf
from .nn.core import materialize_weight_norm, tree_leaves
from .nn.implicit_surface import draw_jitter, draw_probe
from .ops.feature_lookup import fuse_pyramid
from .ops.sparse import occupied_blocks_host


def init(model, seed, device):
    """(params, state, static) of the model section ``model`` (a dict), drawn
    from a generator on ``device`` seeded with ``seed``."""
    return surf.init(Conf(model), seed=seed, device=device)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def tree_to(tree, device):
    """A copy of ``tree`` on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def named_leaves(tree, prefix=""):
    """[(path, tensor)] of a tree of dicts and lists, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def to_device(inputs, device):
    """numpy item -> tensors on ``device`` (strings dropped; f64 -> f32)."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, str):
            continue
        a = np.asarray(v)
        out[k] = torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64 else a) \
            .to(device)
    return out


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

@torch.no_grad()
def build(params, state, static, ipts):
    """FPN features and the cascade: (features, stages, matching volume)."""
    features = feature_net.apply(params["feature_network"], ipts["imgs"])
    _, stages, matching, _ = surf.build_volumes(params, state, static, ipts, features)
    return features, stages, matching


@torch.no_grad()
def lattice(params, static, stages_ff, resolution, block=64, blocks_per_call=8):
    """The (R, R, R) SDF lattice over [-1, 1]^3: +100 in the blocks that no
    active voxel covers and outside the active set, the SDF elsewhere."""
    R, G = int(resolution), int(blocks_per_call)
    B = min(int(block), R)
    dev = stages_ff[0][1].device
    p = materialize_weight_norm(params["implicit_surface"])["sdf_network"]
    occupied = np.argwhere(occupied_blocks_host(stages_ff, R, B))
    u = np.full((R, R, R), 100.0, np.float32)
    ar = torch.arange(B, device=dev)
    scale = 2.0 / (R - 1.0)
    for s in range(0, len(occupied), G):
        sel = occupied[s:s + G]
        origins = torch.from_numpy(sel * B).to(dev)
        idx = torch.minimum(origins[:, :, None] + ar[None, None, :],
                            torch.tensor(R - 1, device=dev))
        q = -1.0 + scale * idx.float()
        shp = (len(sel), B, B, B)
        pts = torch.stack([q[:, 0, :, None, None].expand(shp),
                           q[:, 1, None, :, None].expand(shp),
                           q[:, 2, None, None, :].expand(shp)], dim=-1).reshape(-1, 3)
        out, occ = sdf_net.apply_occ(p, static["implicit_surface"]["sdf"], pts, stages_ff)
        vals = torch.where(occ, out[:, 0], torch.full_like(out[:, 0], 100.0))
        vals = vals.reshape(-1, B, B, B).cpu().numpy()
        for (bx, by, bz), v in zip(sel, vals):
            sx = slice(bx * B, min((bx + 1) * B, R))
            sy = slice(by * B, min((by + 1) * B, R))
            sz = slice(bz * B, min((bz + 1) * B, R))
            u[sx, sy, sz] = v[:sx.stop - sx.start, :sy.stop - sy.start, :sz.stop - sz.start]
    return u


@torch.no_grad()
def render(params, static, ipts, stages_ff, matching, feats_ff, chunk, generator):
    """The validation rays in chunks of ``chunk``: (colour, normal in the
    reference camera's frame, sdf depth, render depth) as numpy arrays."""
    isf = materialize_weight_norm(params["implicit_surface"])
    st = static["implicit_surface"]
    fused = fuse_pyramid(ipts["imgs"], feats_ff) if st.get("fused_pyramid") else None
    rays_o, rays_d = ipts["rays_o"], ipts["rays_d"]
    n, dev = rays_o.shape[0], rays_o.device
    near, far = ipts["near"].reshape(1, 1), ipts["far"].reshape(1, 1)
    outs = []
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        jitter = draw_jitter(st, m, generator, dev)
        probe = draw_probe(generator, dev)
        r = implicit_surface.render(
            isf, st, rays_o[s:s + m], rays_d[s:s + m], near, far, matching, stages_ff,
            feats_ff, ipts["imgs"], ipts["intrs"], ipts["c2ws"], 1.0, fused_colors=fused,
            pts_random=probe, z_jitter=jitter)
        normal = (r["gradients"] * r["weights"][..., None]
                  * r["inside_sphere"][..., None]).sum(1)
        outs.append(torch.cat([r["color_fine"], normal, r["sdf_depth"].reshape(-1, 1),
                               r["render_depth"].reshape(-1, 1)], dim=1).cpu())
    h, w = [int(x) for x in ipts["hw"].reshape(-1)]
    cat = torch.cat(outs).numpy()
    rot = np.linalg.inv(ipts["c2ws"][0, :3, :3].cpu().numpy())
    normal = (rot @ cat[:, 3:6].T).T.reshape(h, w, 3)
    return (cat[:, :3].reshape(h, w, 3), normal, cat[:, 6].reshape(h, w),
            cat[:, 7].reshape(h, w))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def warmup_cosine(total_steps, warmup=0.2, alpha=0.1):
    """surf_tpu_torch/utils/scheduler.py: epoch -> LR multiplier."""
    def scale(step):
        step = np.float32(step)
        if step < warmup:
            return float(np.float32(0.1) + np.float32(0.9) * step / np.float32(warmup))
        cos = (np.cos(np.float32(np.pi) * (step - np.float32(warmup))
                      / np.float32(total_steps - warmup)) + np.float32(1.0)) \
            * np.float32(0.5) * np.float32(1 - alpha) + np.float32(alpha)
        return float(np.float32(cos))
    return scale


class TrainStep:
    """The program's ``Trainer.step``: the loss of one batch, one backward,
    one Adam step of the two groups (``mlp``: the implicit surface at
    ``mlp_lr``; ``feat``: the rest at ``feat_lr``) under the warmup-cosine
    schedule, and the batch-norm state the forward returned."""

    def __init__(self, params, state, static, train, steps_per_epoch):
        self.params, self.state, self.static = params, state, static
        for t in tree_leaves(params):
            t.requires_grad_(True)
        train = Conf(train)
        self.loss_cfg = make_loss_config(train["loss"])
        self.anneal_end = train.get_float("anneal_end", default=0.0)
        lr_scale = warmup_cosine(train.get_int("epochs"), train.get_float("warmup"),
                                 train.get_float("alpha"))
        mlp_lr = train.get_float("lr_conf.mlp_lr")
        feat_lr = train.get_float("lr_conf.feat_lr", default=mlp_lr)
        mlp = tree_leaves(params["implicit_surface"])
        feat = [t for k, v in params.items() if k != "implicit_surface"
                for t in tree_leaves(v)]
        self.optimizer = torch.optim.Adam(
            [{"params": mlp, "lr": mlp_lr}, {"params": feat, "lr": feat_lr}],
            betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: lr_scale(k / steps_per_epoch))

    def restore(self, moments, n_steps):
        """Adam's moments (one (exp_avg, exp_avg_sq, step) or None a
        parameter, in ``tree_leaves`` order) and the schedule after
        ``n_steps`` steps."""
        for t, m in zip(tree_leaves(self.params), moments):
            if m is not None:
                self.optimizer.state[t] = {
                    "step": torch.tensor(float(m[2])),
                    "exp_avg": m[0].to(t.device, copy=True),
                    "exp_avg_sq": m[1].to(t.device, copy=True)}
        self.scheduler.last_epoch = n_steps
        for g, base, lam in zip(self.optimizer.param_groups, self.scheduler.base_lrs,
                                self.scheduler.lr_lambdas):
            g["lr"] = base * lam(n_steps)

    def step(self, batch, step_f, generator):
        """One step; returns (loss terms as floats, the gradients as Adam got
        them, one a parameter in ``tree_leaves`` order)."""
        self.optimizer.zero_grad(set_to_none=True)
        anneal = 1.0 if self.anneal_end == 0.0 else min(1.0, step_f / self.anneal_end)
        outputs, new_state = surf.forward(self.params, self.state, self.static, batch,
                                          cos_anneal_ratio=anneal, step=step_f,
                                          perturb=True, generator=generator)
        res = compute_loss(self.loss_cfg, outputs, batch, step_f, "train")
        res["loss"].backward()
        grads = [None if t.grad is None else t.grad.detach().clone()
                 for t in tree_leaves(self.params)]
        self.optimizer.step()
        self.scheduler.step()
        self.state = new_state
        terms = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                 for k, v in res.items()}
        return terms, grads
