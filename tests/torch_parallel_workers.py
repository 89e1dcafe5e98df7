"""The ranks of the parallel tests (tests/test_torch_parallel*.py): each
function runs in a process that ``surf_tpu_torch.parallel.distribute.spawn``
starts, joins the gloo group through a ``file://`` rendezvous it is
given, and writes what the test compares into ``out``.  Imports no JAX
(the ranks start from a fresh interpreter)."""

import os

import numpy as np
import torch
import torch.distributed as dist

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.nn.core import tree_leaves
from surf_tpu_torch.parallel.distribute import maybe_initialize
from surf_tpu_torch.parallel.mesh import dp_train_step
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import load_checkpoint, to_torch_tree
from surf_tpu_torch.validate import Validator, to_device


def _join(url, threads=None):
    """Join the gloo group; the ranks share the host's cores (``threads``
    each, by default an equal share).  CPU kernels sum in an order that
    depends on their thread count."""
    maybe_initialize(device="cpu", init_method=url)
    torch.set_num_threads(threads or max(1, torch.get_num_threads() // dist.get_world_size()))
    return dist.get_rank()


def _leave():
    """Leave the group once every rank is done (a rank that exits while
    another still talks to it can abort that one)."""
    dist.barrier()
    dist.destroy_process_group()


def paths(tree, path=()):
    """[(path, leaf)] of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, path + (i,))]
    return [(path, tree)]


def key(prefix, path):
    return prefix + ".".join(map(str, path))


def _leaves(prefix, tree, grad=False):
    return {key(prefix, p): (t.grad if grad else t).detach().cpu().numpy()
            for p, t in paths(tree)}


def dp_steps(url, conf_text, init_path, cases, out, threads):
    """For each case (name, scene files, weights, pts_random files, step_f):
    a Trainer from the saved initial parameters takes one data-parallel
    step on this rank's scene, perturbation off; the loss terms, the new
    parameters and their all-reduced gradient, and the new state go to
    ``<out>/<name>_rank<r>.npz``, keyed by tree path (``key``)."""
    rank = _join(url, threads)
    conf = ConfigFactory.parse_string(conf_text)
    init = load_checkpoint(init_path)
    for name, scenes, weights, probes, step_f in cases:
        t = Trainer(conf, device="cpu", base_exp_dir=out,
                    params=to_torch_tree(init["model"]), state=to_torch_tree(init["state"]))
        t.static["implicit_surface"] = dict(t.static["implicit_surface"], perturb=0.0)
        batch = to_device(dict(np.load(scenes[rank])), "cpu")
        res = dp_train_step(t, batch, step_f, weights, perturb=False,
                            pts_random=torch.from_numpy(np.load(probes[rank])))
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
                 terms=np.asarray([res[k] for k in sorted(res)]),
                 names=np.asarray(sorted(res)),
                 **_leaves("p.", t.params), **_leaves("g.", t.params, grad=True),
                 **_leaves("s.", t.state))
    _leave()


def cli(url, argv, out):
    """``surf_tpu_torch.main`` on this rank; its trainer's parameters,
    Adam moments and schedule go to ``<out>/rank<r>.npz``."""
    from surf_tpu_torch import main
    # one thread a rank: the ranks share the host's cores with the suite's
    # other workers
    torch.set_num_threads(1)
    t = main.main(list(argv) + ["--dist_url", url])
    rank = dist.get_rank()
    os.makedirs(out, exist_ok=True)
    moments = [t.optimizer.state[p][k].numpy() for p in tree_leaves(t.params)
               for k in ("exp_avg", "exp_avg_sq")]
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             start_epoch=t.start_epoch, last_epoch=t.scheduler.last_epoch,
             lrs=np.asarray([g["lr"] for g in t.optimizer.param_groups]),
             **_leaves("p.", t.params), **{f"m{i}": m for i, m in enumerate(moments)})
    _leave()


def cli_refused(url, argv, out):
    """``surf_tpu_torch.main`` on this rank, which should refuse: the
    message it exits with goes to ``<out>/refused<r>.txt`` (empty if it
    ran)."""
    from surf_tpu_torch import main
    msg = ""
    try:
        main.main(list(argv) + ["--dist_url", url])
    except SystemExit as e:
        msg = str(e)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"refused{dist.get_rank()}.txt"), "w") as f:
        f.write(msg)
    _leave()


def node_validate(url, conf_text, mesh_resolution, out, threads):
    """One validate of the seeded tiny model, this rank writing under
    ``<out>/rank<r>``; its node (``LOCAL_WORLD_SIZE`` ranks), its ray
    group's ranks and the metrics it returns go to ``<out>/rank<r>.json``."""
    import json
    from surf_tpu_torch.parallel.distribute import local_rank_and_size, node_index_and_count
    rank = _join(url, threads)
    v = Validator(ConfigFactory.parse_string(conf_text), device="cpu",
                  mesh_resolution=mesh_resolution,
                  base_exp_dir=os.path.join(out, f"rank{rank}"))
    results = v.validate()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"local": list(local_rank_and_size()), "node": list(node_index_and_count()),
                   "group": dist.get_process_group_ranks(v.group), "results": results}, f)
    _leave()


def sharded_validate(url, confs, params_path, mesh_resolution, out, threads):
    """For each (name, conf text): one validate of the saved parameters
    with the render and the lattice sharded over the ranks; the first
    rank's image and lattice, and every rank's metrics, go to
    ``<out>/<name>_rank<r>.npz``."""
    rank = _join(url, threads)
    ck = load_checkpoint(params_path)
    for name, conf_text in confs:
        v = Validator(ConfigFactory.parse_string(conf_text), device="cpu",
                      mesh_resolution=mesh_resolution, base_exp_dir=os.path.join(out, name),
                      params=to_torch_tree(ck["model"]), state=to_torch_tree(ck["state"]))
        got = record_image_and_lattice(v)
        (m,) = v.validate()
        arrays = {}
        if got["image"] is not None:
            arrays = dict(zip(IMAGE_KEYS, got["image"]), lattice=got["lattice"][2])
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), psnr=m["psnr"],
                 mesh_faces=m["mesh_faces"], mesh_vertices=m["mesh_vertices"], **arrays)
    _leave()


IMAGE_KEYS = ("color", "normal", "sdf_depth", "render_depth")


def record_image_and_lattice(v):
    """Keep what ``v.validate`` renders and extracts: a dict that gets
    ``image`` and ``lattice`` (None on a rank other than the first)."""
    got, render, extract = {}, v.render_full_image, v.extract_geometry

    def keep_image(*a):
        got["image"] = render(*a)
        return got["image"]

    def keep_lattice(*a, **k):
        got["lattice"] = extract(*a, **k)
        return got["lattice"]
    v.render_full_image, v.extract_geometry = keep_image, keep_lattice
    return got
