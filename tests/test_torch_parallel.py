"""Port parity of the data-parallel training step: ``surf_tpu_torch``'s
``parallel.mesh.dp_train_step`` on 2 gloo ranks on the CPU against
``surf_tpu.parallel.make_dp_train_step`` on 2 of conftest's 8 virtual CPU
devices, from the same parameters (JAX init, carried over by
``convert.from_jax``), the same two scenes, each with the SDF probe
points its JAX key draws, perturbation off on both sides (JAX's
``surf.forward`` patched to ``perturb=False``, the render's ``perturb``
0), the JAX runner's two-group Adam and schedule.

Tolerances, all f32: loss terms rtol 1e-4 / atol 1e-5 (as the one-scene
step's); the all-reduced gradient against JAX's weighted gradient (read
from its Adam state) within 1e-3 of the leaf's largest entry (the
one-scene step's gradient tolerance) plus 1e-7 (the leaves whose gradient
is 0 by softmax shift invariance come out as round-off of order 1e-8 in a
mean of two scenes, on both sides); the new parameters against
the JAX runner's optax Adam applied to that gradient, rtol 1e-5 (the Adam
test's), and against JAX's own new parameters within two steps' length
(Adam's first step moves an entry by ``lr g / (|g| + 1e-8)``, so an
entry whose gradient is near 0 or round-off moves by an amount the
gradient tolerance does not fix); the batch-norm running statistics
averaged with the weights 1e-5.  Weights [1, 1] and [1, 0]; at [1, 0]
the update is the one-process step on the first scene bit for bit.
Also the rendezvous detection on torchrun's and SLURM's variables, the
backend rule and the shard arithmetic."""

import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tiny_conf import tiny_conf, TINY
import torch_parallel_workers as workers
from surf_tpu.data.synthetic import SyntheticDataset as JDataset
from surf_tpu.losses import make_loss_config as j_cfg
from surf_tpu.nn import surf as jsurf
from surf_tpu.parallel import make_mesh, make_dp_train_step, stack_batches
from surf_tpu.runner import Runner
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.parallel import distribute, mesh
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import save_checkpoint, to_numpy_tree
from surf_tpu_torch.validate import to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

STEP_F = 0.5
CASES = {"w11": ((0, 1), (1.0, 1.0)), "w10": ((0, 1), (1.0, 0.0))}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [(path, tree)]


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# -- the rendezvous, the backend rule and the shard arithmetic -------------------

def test_distribute_single_process_noop():
    """A single process joins no group (the reference's 'Not using
    distributed mode' branch)."""
    assert distribute.detect_multiprocess_env({}) is None
    assert distribute.detect_multiprocess_env({"SLURM_NTASKS": "1"}) is None
    assert distribute.maybe_initialize(None, environ={}) is False
    assert not torch.distributed.is_initialized()
    assert distribute.process_count() == 1 and distribute.is_main_process()
    assert distribute.local_rank_and_size() == (0, 1)


def test_distribute_env_detection():
    got = distribute.detect_multiprocess_env({
        "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"})
    assert got == {"rank": 5, "world_size": 8, "local_rank": 1, "local_world_size": 4}
    # torchrun's variables win over SLURM's, as RANK does in the reference
    got = distribute.detect_multiprocess_env({"RANK": "0", "WORLD_SIZE": "2",
                                              "SLURM_NTASKS": "8", "SLURM_PROCID": "3"})
    assert got["world_size"] == 2 and got["local_world_size"] == 2
    slurm = {"SLURM_NTASKS": "8", "SLURM_PROCID": "6", "SLURM_LOCALID": "2"}
    assert distribute.detect_multiprocess_env(dict(slurm, SLURM_NTASKS_PER_NODE="4")) == {
        "rank": 6, "world_size": 8, "local_rank": 2, "local_world_size": 4}
    assert distribute.detect_multiprocess_env(
        dict(slurm, SLURM_TASKS_PER_NODE="4(x2)"))["local_world_size"] == 4
    assert distribute.detect_multiprocess_env(slurm)["local_world_size"] == 8


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distribute.choose_backend(1, "cuda") == "nccl"
    assert distribute.choose_backend(2, "cuda") == "gloo"      # two ranks, one card
    assert distribute.choose_backend(1, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distribute.choose_backend(4, "cuda") == "nccl"
    assert distribute.rank_device("cuda", 6) == torch.device("cuda", 2)
    assert distribute.rank_device("cpu", 6) == torch.device("cpu")


def test_process_slice_shard_math(monkeypatch):
    """One scene a rank: rank r owns scene r of the super-batch."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    assert mesh.process_slice(2) == (1, 1)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    assert mesh.process_slice(8) == (0, 1)
    assert mesh.weight_scale([1.0, 1.0, 0.0], 1) == 0.5
    assert mesh.weight_scale([1.0, 0.0], 1) == 0.0
    assert mesh.weight_scale([0.0, 0.0], 0) == 0.0


# -- the step against JAX ---------------------------------------------------------

def _runner_optimizer(conf, steps):
    """The JAX runner's own ``_make_optimizer`` and ``_label_fn``."""
    ns = SimpleNamespace(_steps_per_epoch=steps, lr_conf=conf["train.lr_conf"],
                         _lr_scale=j_sched(conf.get_int("train.epochs"),
                                           conf.get_float("train.warmup"),
                                           conf.get_float("train.alpha")))
    ns._label_fn = lambda p: Runner._label_fn(ns, p)
    return Runner._make_optimizer(ns)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    conf = tiny_conf()
    ds = JDataset(conf["train_dataset"], "train")
    scenes = [ds[0], ds[1]]
    params, state, static = jsurf.init(jax.random.PRNGKey(0), conf["model"])
    static_j = dict(static, remat_stages=False,
                    implicit_surface=dict(static["implicit_surface"], perturb=0.0))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), 2))
    # the probe points each scene's key draws in render_core
    probes = [np.asarray(jax.random.uniform(
        jax.random.split(jax.random.split(k)[1])[1], (1024, 3)) * 2.0 - 1.0) for k in keys]
    opt = _runner_optimizer(conf, len(ds))
    dmesh = make_mesh(jax.devices()[:2])
    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsurf, "forward", functools.partial(jsurf.forward, perturb=False))
        step, sharded, replicated = make_dp_train_step(
            opt, static_j, j_cfg(conf["train.loss"]), dmesh)
        params_np, state_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
        opt_np = jax.tree.map(np.asarray, opt.init(params))
        for name in CASES:
            idx, w = CASES[name]
            put = functools.partial(jax.device_put, device=sharded)
            batch = {k: put(jnp.asarray(v)) for k, v in
                     stack_batches([scenes[i] for i in idx]).items()}
            new_p, new_s, new_opt, res = step(
                jax.device_put(params_np, replicated), jax.device_put(state_np, replicated),
                jax.device_put(opt_np, replicated), batch, put(jnp.asarray(keys[list(idx)])),
                put(jnp.asarray(w, jnp.float32)), jnp.float32(STEP_F),
                jnp.float32(min(1.0, STEP_F)))
            # Adam's first moment after one step: 0.1 x the weighted gradient
            mu = {g: s.inner_state[0].mu for g, s in new_opt.inner_states.items()}
            jax_out[name] = (jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s),
                             {k: float(v) for k, v in res.items()}, mu)

    # the port: 2 gloo ranks from the same parameters, scenes and probes
    tp, ts = from_jax(params_np, state_np)
    init = str(tmp / "init.ckpt.npz")
    save_checkpoint(init, {"model": to_numpy_tree(tp), "state": to_numpy_tree(ts)})
    files = []
    for i, (sc, pr) in enumerate(zip(scenes, probes)):
        files.append((str(tmp / f"scene{i}.npz"), str(tmp / f"probe{i}.npy")))
        np.savez(files[-1][0], **{k: v for k, v in sc.items() if not isinstance(v, str)})
        np.save(files[-1][1], pr)
    cases = [(name, [files[i][0] for i in idx], list(w), [files[i][1] for i in idx], STEP_F)
             for name, (idx, w) in CASES.items()]
    # the ranks' CPU thread count, which the one-process step compared with
    # them bit for bit also takes: CPU kernels sum in an order that depends
    # on it
    threads = max(1, torch.get_num_threads() // 2)
    distribute.spawn(workers.dp_steps, 2, (f"file://{tmp}/rdzv", TINY, init, cases,
                                           str(tmp), threads), timeout=600)
    port = {name: [dict(np.load(tmp / f"{name}_rank{r}.npz")) for r in range(2)]
            for name in CASES}
    return dict(jax=jax_out, port=port, tp=tp, ts=ts, np_trees=(params_np, state_np), opt=opt,
                threads=threads,
                scenes=scenes,
                probes=probes, conf=conf)


@pytest.mark.parametrize("case", ["w11", "w10"])
def test_dp_step_loss_terms_match_jax(run, case):
    res_j = run["jax"][case][2]
    for r in range(2):
        got = run["port"][case][r]
        names = [str(n) for n in got["names"]]
        assert set(names) == set(res_j)
        for n, v in zip(names, got["terms"]):
            np.testing.assert_allclose(v, res_j[n], rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("case", ["w11", "w10"])
def test_dp_step_gradient_matches_jax(run, case):
    """The all-reduced gradient, equal on both ranks, against the weighted
    gradient of JAX's step (its Adam first moment / 0.1), within the
    one-scene step's gradient tolerance."""
    r0, r1 = run["port"][case]
    mu = run["jax"][case][3]
    for path, _ in _paths(run["tp"]):
        k = workers.key("g.", path)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        group = "mlp" if path[0] == "implicit_surface" else "feat"
        ref = np.asarray(_get(mu[group], path), np.float64) / 0.1
        assert np.abs(r0[k] - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-7, k


@pytest.mark.parametrize("case", ["w11", "w10"])
def test_dp_step_parameters_match_jax_adam(run, case):
    """Both ranks hold the same new parameters bit for bit, and they are
    the JAX runner's optax Adam applied to that gradient from the same
    parameters, within the Adam test's rtol 1e-5."""
    r0, r1 = run["port"][case]
    params_np = run["np_trees"][0]
    flat, treedef = jax.tree_util.tree_flatten_with_path(params_np)
    ids = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp) for kp, _ in flat]
    grads = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(r0[workers.key("g.", p)]) for p in ids])
    opt = run["opt"]
    upd, _ = opt.update(grads, opt.init(params_np), params_np)
    p_j = jax.tree.map(np.asarray, optax.apply_updates(params_np, upd))
    moved = 0
    for path, t0 in _paths(run["tp"]):
        k = workers.key("p.", path)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], np.asarray(_get(p_j, path)), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
        moved += not np.array_equal(r0[k], t0.detach().numpy())
    assert moved > 0.9 * len(_paths(run["tp"]))
    # JAX's own new parameters: each side moved at most one step, lr, from
    # the same start
    lr = max(float(v) for v in run["conf"]["train.lr_conf"].values())
    for path, _ in _paths(run["tp"]):
        ref = np.asarray(_get(run["jax"][case][0], path))
        assert np.abs(r0[workers.key("p.", path)] - ref).max() <= 2 * lr, path


@pytest.mark.parametrize("case", ["w11", "w10"])
def test_dp_step_weighted_batch_norm_state_matches_jax(run, case):
    s_j = run["jax"][case][1]
    r0, r1 = run["port"][case]
    for path, _ in _paths(run["ts"]):
        k = workers.key("s.", path)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], np.asarray(_get(s_j, path)), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_dp_zero_weight_padding_matches_unpadded(run):
    """A zero-weight scene in the super-batch (the loop pads the ragged
    last one with the last item at weight 0) changes nothing: (a, b) at
    weights [1, 0] gives the update, new state and loss terms of a
    one-process step on a alone, bit for bit."""
    tconf = ConfigFactory.parse_string(TINY)
    tp, ts = from_jax(*run["np_trees"])
    t = Trainer(tconf, device="cpu", params=tp, state=ts)
    t.static["implicit_surface"] = dict(t.static["implicit_surface"], perturb=0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(run["threads"])
    try:
        res, new_state = t.loss(to_device(run["scenes"][0], "cpu"), STEP_F, min(1.0, STEP_F),
                                perturb=False,
                                pts_random=torch.from_numpy(run["probes"][0].copy()))
        res["loss"].backward()
        t.update()
    finally:
        torch.set_num_threads(threads)
    w10 = run["port"]["w10"][0]
    for path, p in _paths(t.params):
        k = workers.key("p.", path)
        np.testing.assert_array_equal(w10[k], p.detach().numpy(), err_msg=k)
    for path, s in _paths(new_state):
        k = workers.key("s.", path)
        np.testing.assert_array_equal(w10[k], s.numpy(), err_msg=k)
    terms = dict(zip([str(n) for n in w10["names"]], w10["terms"]))
    for k, v in res.items():
        assert terms[k] == np.float32(float(v.detach()) if torch.is_tensor(v) else v), k
