"""Ray-axis sharding of the validate's render and SDF lattice across the
ranks of a node (the counterpart of surf_tpu/parallel/ray_shard.py).

The per-ray and per-point work is embarrassingly parallel: each rank of
the node's group evaluates its rows of a chunk (rays of a render chunk,
occupied blocks of the mesh lattice) and the group's first rank gathers
the whole chunk, which it copies to the host (the mesh lattice's values
also stay on its card under nccl, for marching cubes there).  The render
chunk is rounded up to a multiple of the rank count, as the JAX runner
sizes it (surf_tpu/runner.py:518-522); the random numbers of a chunk (the
z jitter under ``render.perturb``, the SDF probe points) are drawn whole,
by every rank from the same-seeded generator, and each rank keeps its
rows, so the sharded render equals the one-process render with or
without perturbation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .distribute import local_rank_and_size

_GROUPS = {}


def ray_group(conf=None):
    """The process group of this node's ranks, or None for one rank, a
    single process, or ``train.val_ray_shard = false`` (default true).
    Every rank calls it at the same point (it may create the groups)."""
    if not dist.is_initialized():
        return None
    if conf is not None and not conf.get_bool("train.val_ray_shard", default=True):
        return None
    _, size = local_rank_and_size()
    if size <= 1:
        return None
    if size == dist.get_world_size():
        return dist.group.WORLD
    if size not in _GROUPS:
        _GROUPS[size] = dist.new_subgroups(group_size=size)[0]
    return _GROUPS[size]


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def is_root(group):
    """Whether this rank is the first of ``group`` (or there is no group)."""
    return group is None or dist.get_rank(group) == 0


def padded_chunk(chunk, group):
    """``chunk`` rounded up to a multiple of the group's rank count."""
    w = group_size(group)
    return -(-chunk // w) * w


def to_host(t):
    """``t`` on the host; a card tensor is copied into page-locked memory:
    one DMA at the link's rate, where a pageable destination goes through a
    staging buffer (the DTU lattice's 0.28 GB: 0.15 s pageable, 7 ms pinned
    on the H100); PyTorch's host allocator keeps the block for the next
    copy."""
    if t.device.type != "cuda":
        return t.cpu()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def gather_rows(t, group):
    """Every rank's ``t`` (k, ...) concatenated in rank order on the
    group's first rank, where the group gathers: host tensors under gloo,
    card tensors under nccl; None on the other ranks."""
    dev = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    x = t.detach().to(dev).contiguous()
    ranks = dist.get_process_group_ranks(group)
    out = [torch.empty_like(x) for _ in ranks] if is_root(group) else None
    dist.gather(x, out, dst=ranks[0], group=group)
    return torch.cat(out) if out is not None else None


def shard_rows(fn, n, group, device=None):
    """Rows [0, n) evaluated across ``group``: rank r calls ``fn(rows)``
    on rows [r k, (r + 1) k), k = ceil(n / ranks), the rows past n
    repeating row n - 1, and ``fn`` returns (k, ...); the first rank gets
    all n rows (where ``gather_rows`` leaves them), the others None.
    Without a group, ``fn`` takes all n rows and its result is returned
    where it lies.  The caller copies them to the host (``to_host``)."""
    if group is None:
        return fn(torch.arange(n, device=device))
    w, r = group_size(group), dist.get_rank(group)
    k = -(-n // w)
    rows = torch.arange(r * k, (r + 1) * k, device=device).clamp_(max=n - 1)
    out = gather_rows(fn(rows), group)
    return out[:n] if out is not None else None


def broadcast_object(obj, group):
    """The group's first rank's ``obj`` on every rank of ``group``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_process_group_ranks(group)[0], group=group)
    return box[0]
