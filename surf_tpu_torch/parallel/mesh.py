"""Scene data parallelism over ranks, one scene a rank (the counterpart of
surf_tpu/parallel/mesh.py's ``make_dp_train_step`` and the super-batch
loop of surf_tpu/runner.py:316-372).

A super-batch holds one scene a rank, each with a weight: 1 for a real
scene, 0 for the duplicates that pad the epoch's last super-batch.  The
step's loss is ``sum_i w_i L_i / max(sum_i w_i, 1)``.  Every rank knows
all the weights, so rank r backpropagates ``w_r L_r / max(sum w, 1)`` on
its own scene (nothing at weight 0), and the gradients are summed with
``all_reduce``, flattened into one buffer a dtype; a leaf with no
gradient adds zeros.  The batch-norm running statistics (the step's new
state) and the loss terms are averaged with the same weights (the JAX
step's ``wmean``).  Then every rank runs the same two-group Adam update
and schedule step, so the replicas stay equal bit for bit; the
parameters are broadcast from rank 0 once, at start-up.

With the ``gloo`` backend (ranks sharing a card) the buffers go through
the host.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..nn.core import tree_leaves


def process_slice(n_global):
    """(start, count) of this rank's scenes within a super-batch of
    ``n_global`` scenes: one scene a rank."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank, 1


def _staged(group):
    """Whether collectives on card tensors go through the host."""
    return dist.get_backend(group) == "gloo"


def _flat_buffers(tensors):
    """dtype -> (the tensors of that dtype, one flat copy of them)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return {dt: (ts, torch.cat([t.reshape(-1) for t in ts])) for dt, ts in by_dtype.items()}


def _collective(buf, fn, group):
    """Run ``fn(buffer)`` in place on ``buf``, through the host under gloo."""
    if buf.device.type == "cuda" and _staged(group):
        host = buf.cpu()
        fn(host)
        buf.copy_(host)
    else:
        fn(buf)


def _unflatten(tensors, flat):
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_reduce_sum(tensors, group=None):
    """Sum ``tensors`` over the ranks in place, one collective a dtype.
    Returns the bytes a rank sent."""
    sent = 0
    for ts, flat in _flat_buffers(tensors).values():
        _collective(flat, lambda b: dist.all_reduce(b, group=group), group)
        for t, v in zip(ts, _unflatten(ts, flat)):
            t.copy_(v)
        sent += flat.numel() * flat.element_size()
    return sent


def broadcast_tree(tree, src=0, group=None):
    """Every leaf of ``tree`` set to rank ``src``'s, in place."""
    with torch.no_grad():
        for ts, flat in _flat_buffers(tree_leaves(tree)).values():
            _collective(flat, lambda b: dist.broadcast(b, src, group=group), group)
            for t, v in zip(ts, _unflatten(ts, flat)):
                t.copy_(v)


def weight_scale(weights, rank):
    """``w_rank / max(sum w, 1)``: this rank's share of the step's loss."""
    return float(weights[rank]) / max(float(sum(weights)), 1.0)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _sync(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def dp_train_step(trainer, batch, step_f, weights, *, perturb=True, pts_random=None,
                  group=None, timings=None):
    """One data-parallel step of ``trainer`` (a ``train.Trainer``) on this
    rank's scene ``batch`` (tensors on its device), in a super-batch whose
    scenes have ``weights`` (one a rank, in rank order).  Returns the loss
    terms averaged with the weights, as floats.  ``timings``, a dict, gets
    the gradient all-reduce's seconds and its buffers' bytes."""
    rank = dist.get_rank(group)
    scale = weight_scale(weights, rank)
    denom = max(float(sum(weights)), 1.0)
    trainer.optimizer.zero_grad(set_to_none=True)
    res, new_state = trainer.loss(batch, step_f, trainer.cos_anneal_ratio(step_f),
                                  perturb=perturb, pts_random=pts_random)
    if scale != 0.0:
        (res["loss"] * scale).backward()
    params = tree_leaves(trainer.params)
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if timings is not None:
            _sync(params[0])
        t0 = time.time()
        sent = all_reduce_sum([p.grad for p in params], group)
        if timings is not None:
            _sync(params[0])
            timings.update(all_reduce_s=time.time() - t0, grad_bytes=sent)
        # the new state and the loss terms, averaged with the weights
        w = float(weights[rank])
        state = _map_tree(lambda t: t.detach() * w, new_state)
        names = sorted(res)
        terms = torch.stack([torch.as_tensor(res[k], dtype=torch.float32,
                                             device=params[0].device).detach().reshape(())
                             for k in names]) * w
        all_reduce_sum(tree_leaves(state) + [terms], group)
        state = _map_tree(lambda t: t / denom, state)
        terms = (terms / denom).tolist()
    trainer.update()
    trainer.state = state
    return dict(zip(names, terms))
