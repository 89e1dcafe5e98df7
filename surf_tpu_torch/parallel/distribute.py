"""Multi-process initialization: one process a card, ``torch.distributed``
(the counterpart of surf_tpu/parallel/distribute.py).

Rendezvous detection follows the JAX package's precedence, with the
variables torch launchers set (the original reference's
``init_distributed_mode``, utils/distribute.py:66-89):

1. torchrun (``torch.distributed.run``): ``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, with ``MASTER_ADDR`` /
   ``MASTER_PORT`` read by the ``env://`` rendezvous;
2. SLURM with ``SLURM_NTASKS`` > 1: ``SLURM_PROCID``, ``SLURM_LOCALID``,
   ``SLURM_NTASKS`` (and the tasks of a node from
   ``SLURM_NTASKS_PER_NODE`` or ``SLURM_TASKS_PER_NODE``); the rendezvous
   is ``env://``, so ``MASTER_ADDR`` / ``MASTER_PORT`` must be set;
3. neither: a single process, and nothing is initialized (the reference's
   "Not using distributed mode" branch).  ``train.multihost = true``
   forces the ``env://`` rendezvous all the same.

Backend rule, printed once by rank 0: ``nccl`` when every rank of a node
has a card of its own; ``gloo`` when the ranks of a node outnumber its
cards (two ranks sharing one card) and with ``device="cpu"``.  A rank's
card is ``cuda:<local rank % card count>``, made current before any
tensor reaches it.
"""

from __future__ import annotations

import datetime
import os
import re
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the collectives of a run wait at most this long for a rank (a rank that
# died leaves the others waiting on a collective)
TIMEOUT = datetime.timedelta(minutes=10)


def detect_multiprocess_env(environ=None):
    """The rendezvous a launcher set up: dict(rank, world_size, local_rank,
    local_world_size), or None for a single process."""
    env = os.environ if environ is None else environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return {"rank": int(env["RANK"]), "world_size": world,
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
                "local_world_size": int(env.get("LOCAL_WORLD_SIZE", world))}
    world = int(env.get("SLURM_NTASKS", "1"))
    if world > 1:
        per_node = env.get("SLURM_NTASKS_PER_NODE") or \
            re.match(r"\d+", env.get("SLURM_TASKS_PER_NODE", str(world))).group(0)
        return {"rank": int(env["SLURM_PROCID"]), "world_size": world,
                "local_rank": int(env.get("SLURM_LOCALID", "0")),
                "local_world_size": int(per_node)}
    return None


def choose_backend(local_world_size, device="cuda"):
    """``nccl`` when each rank of a node has a card of its own, else
    ``gloo`` (ranks sharing a card, or the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device="cuda", local_rank=None):
    """This rank's device: ``cuda:<local rank % card count>``, or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    lr = local_rank_and_size()[0] if local_rank is None else local_rank
    return torch.device("cuda", lr % torch.cuda.device_count())


# what the rendezvous found: (local rank, local world size); set once by
# maybe_initialize, as torch.distributed's own process group is
_LOCAL = {"rank": 0, "size": 1}


def maybe_initialize(conf=None, environ=None, device="cuda", init_method="env://"):
    """Join the process group the environment describes.  Returns True when
    running multi-process (after ``init_process_group``), False for a
    single process (a no-op).  Idempotent.  ``init_method``: ``env://``
    (torchrun, SLURM) or ``file://<path>`` (ranks spawned by
    ``spawn``)."""
    if dist.is_initialized():
        return True
    env = os.environ if environ is None else environ
    found = detect_multiprocess_env(env)
    force = bool(conf is not None and conf.get_bool("train.multihost", default=False))
    if found is None:
        if not force:
            return False
        found = {"rank": int(env.get("RANK", "0")), "world_size": int(env.get("WORLD_SIZE", "1")),
                 "local_rank": int(env.get("LOCAL_RANK", "0")),
                 "local_world_size": int(env.get("LOCAL_WORLD_SIZE", "1"))}
    backend = choose_backend(found["local_world_size"], device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, found["local_rank"]))
    dist.init_process_group(backend, init_method=init_method, rank=found["rank"],
                            world_size=found["world_size"], timeout=TIMEOUT)
    _LOCAL.update(rank=found["local_rank"], size=found["local_world_size"])
    if found["rank"] == 0:
        cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
        print(f"[distributed] backend {backend}: {found['world_size']} ranks, "
              f"{found['local_world_size']} a node, {cards} cards a node", flush=True)
    return True


def is_main_process():
    return process_index() == 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank_and_size():
    """(rank within the node, ranks of the node)."""
    return (_LOCAL["rank"], _LOCAL["size"]) if dist.is_initialized() else (0, 1)


def node_index_and_count():
    """(this node's index, node count): ranks are numbered node by node."""
    _, size = local_rank_and_size()
    return process_index() // size, max(process_count() // size, 1)


def _rank_main(rank, fn, world, local_world, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_world), LOCAL_WORLD_SIZE=str(local_world))
    fn(*args)


def spawn(fn, world, args=(), timeout=1800.0, local_world_size=None):
    """Run ``fn(*args)`` in ``world`` fresh processes on this host
    (``torch.multiprocessing.spawn``), with torchrun's variables set: rank
    r of ``world``, ``local_world_size`` ranks a node (default all on one
    node; fewer stands in for several nodes).  ``fn`` joins through
    ``maybe_initialize`` with a rendezvous it is given (a ``file://``
    path does for processes of one host) and must be importable by name.
    If a rank fails, the others are ended and torch.multiprocessing's
    ``ProcessException`` is raised; ``TimeoutError`` if the ranks outlive
    ``timeout`` seconds."""
    ctx = mp.spawn(
        _rank_main, args=(fn, world, local_world_size or world, args), nprocs=world,
        join=False)
    end = time.time() + timeout
    while not ctx.join(timeout=1.0):
        if time.time() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
            raise TimeoutError(f"the ranks ran past {timeout} s")
