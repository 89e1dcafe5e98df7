"""Port parity of the training slice: one tiny training step (2-stage
cascade on the synthetic scene, 64 rays) through ``surf_tpu_torch``
against ``jax.value_and_grad`` of ``surf.forward(..., "train")`` +
``compute_loss`` in ``surf_tpu``, from the same parameters (JAX init,
carried over by ``convert.from_jax``), the same batch and the same 1024
SDF probe points; the matching field and the render unperturbed.  Step
1.0 runs the live feature net's patch features, step 2.5 the frozen
matching copy (given its own values here); the second case also runs the
hybrid U-Net at stage 1 (``dense_unet_max_res`` 16), so K4's
transposed-table backward is on the path.

Tolerances, all f32: every loss term rtol 1e-4 / atol 1e-5; every
gradient leaf max|d| <= 1e-3 max|g_jax| + 1e-8 (the same sums in another
order through ~30 layers and three orders of differentiation; the 1e-8
floor covers the three leaves whose gradient is 0 by softmax shift
invariance, which both sides give as round-off of order 1e-9); the
batch-norm running statistics after the step 1e-5.  Also: one optimizer
update against ``optax.multi_transform`` Adam with the runner's schedule
(params within 1e-5 relative), the schedule at 10 fractional epochs, the
npz checkpoint layout read bit for bit by the other package, and the
optimizer-state resume of ``--mode train --resume``: a JAX runner's
checkpoint resumes in the port (moments and counts bit for bit, the next
update within the Adam test's 1e-5), and the port's checkpoint passes the
JAX runner's ``_restore_opt_state`` with its fingerprint.  The training
loop and the CLI are in tests/test_torch_train_loop.py."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tiny_conf import tiny_conf, TINY
from surf_tpu.data.synthetic import SyntheticDataset as JDataset
from surf_tpu.losses import compute_loss as j_loss, make_loss_config as j_cfg
from surf_tpu.nn import surf as jsurf
from surf_tpu.utils import checkpoint as jckpt
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.losses import compute_loss as t_loss, make_loss_config as t_cfg
from surf_tpu_torch.nn import surf as tsurf
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import checkpoint as tckpt
from surf_tpu_torch.utils.scheduler import warmup_cosine as t_sched
from surf_tpu_torch.validate import to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

ANNEAL = 0.5
CASES = {"step1_dense": (1.0, 176), "step2.5_hybrid": (2.5, 16)}


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


@pytest.fixture(scope="module")
def setup():
    conf = tiny_conf()
    batch = JDataset(conf["train_dataset"], "train")[0]
    params, state, static = jsurf.init(jax.random.PRNGKey(0), conf["model"])
    rng = np.random.RandomState(4)
    # a frozen matching copy that differs from the live net, so the two
    # patch-feature branches give different values
    state = dict(state, match_feature_network=jax.tree.map(
        lambda x: x + jnp.asarray(rng.randn(*x.shape) * 0.05, x.dtype),
        state["match_feature_network"]))
    key = jax.random.PRNGKey(3)
    # the probe points JAX's render_core draws from this key
    k_core = jax.random.split(jax.random.split(key)[1])[1]
    pts_random = np.asarray(jax.random.uniform(k_core, (1024, 3)) * 2.0 - 1.0)
    return dict(conf=conf, batch=batch, params=params, state=state, static=static,
                key=key, pts_random=pts_random, results={})


def _run(setup, case):
    if case in setup["results"]:
        return setup["results"][case]
    step_f, dmr = CASES[case]
    conf, batch, params, state = (setup[k] for k in ("conf", "batch", "params", "state"))
    static_j = dict(setup["static"], remat_stages=False, dense_unet_max_res=dmr,
                    implicit_surface=dict(setup["static"]["implicit_surface"], perturb=0.0))
    bj = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, str)}
    cfg = j_cfg(conf["train.loss"])

    def loss_fn(p):
        out, ns = jsurf.forward(setup["key"], p, state, static_j, "train", bj,
                                cos_anneal_ratio=ANNEAL, step=step_f, perturb=False)
        res = j_loss(cfg, out, bj, step_f, "train")
        return res["loss"], (res, ns)

    (_, (res_j, ns_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tconf = ConfigFactory.parse_string(TINY)
    tp, ts = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    leaves = _paths(tp)
    for _, t in leaves:
        t.requires_grad_(True)
    _, _, static_t = tsurf.init(tconf["model"], device="cpu")
    static_t["dense_unet_max_res"] = dmr
    static_t["implicit_surface"] = dict(static_t["implicit_surface"], perturb=0.0)
    bt = to_device(batch, "cpu")
    out_t, ns_t = tsurf.forward(tp, ts, static_t, bt, cos_anneal_ratio=ANNEAL,
                                step=step_f, perturb=False,
                                pts_random=torch.from_numpy(setup["pts_random"].copy()))
    res_t = t_loss(t_cfg(tconf["train.loss"]), out_t, bt, step_f, "train")
    res_t["loss"].backward()
    setup["results"][case] = (res_j, g_j, ns_j, res_t, leaves, ns_t)
    return setup["results"][case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_terms_match_jax(setup, case):
    res_j, _, _, res_t, _, _ = _run(setup, case)
    assert set(res_j) == set(res_t)
    for k in res_j:
        got = float(res_t[k].detach()) if torch.is_tensor(res_t[k]) else float(res_t[k])
        np.testing.assert_allclose(got, float(res_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(res_j["mfc_loss"]) > 0 and float(res_j["photo_loss"]) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_gradient_leaf_matches_jax(setup, case):
    _, g_j, _, _, leaves, _ = _run(setup, case)
    assert len(leaves) == len(jax.tree.leaves(g_j))
    nonzero = 0
    for path, t in leaves:
        ref = np.asarray(_get(g_j, path))
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(ref)
        assert got.shape == ref.shape, path
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-3 * scale + 1e-8, path
        nonzero += scale > 1e-6
    assert nonzero > 0.9 * len(leaves)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_norm_running_stats_match_jax(setup, case):
    _, _, ns_j, _, _, ns_t = _run(setup, case)
    for s, (sj, st) in enumerate(zip(ns_j["reg_network"], ns_t["reg_network"])):
        assert sorted(sj) == sorted(st)
        for name in sj:
            for k in ("mean", "var"):
                np.testing.assert_allclose(st[name]["bn"][k].numpy(),
                                           np.asarray(sj[name]["bn"][k]), rtol=1e-5,
                                           atol=1e-5, err_msg=f"stage {s} {name} {k}")
    # the state moved and the frozen copy rides along unchanged
    assert not np.allclose(np.asarray(ns_j["reg_network"][0]["conv0"]["bn"]["var"]), 1.0)
    for (p, a), (_, b) in zip(_paths(ns_t["match_feature_network"]),
                              _paths(setup["state"]["match_feature_network"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(p))


def test_trainer_update_matches_optax_adam(setup):
    """Two updates of the Trainer's optimizer (two Adam groups under the
    warmup-cosine LambdaLR) against the runner's optax.multi_transform
    with the same gradients."""
    _, g_j, _, _, _, _ = _run(setup, "step1_dense")
    conf, params = setup["conf"], setup["params"]
    tconf = ConfigFactory.parse_string(TINY)
    tp, ts = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, setup["state"]))
    trainer = Trainer(tconf, device="cpu", params=tp, state=ts)
    steps = trainer.steps_per_epoch
    assert steps == len(JDataset(conf["train_dataset"], "train"))
    sched = j_sched(conf.get_int("train.epochs"), conf.get_float("train.warmup"),
                    conf.get_float("train.alpha"))
    lr = conf["train.lr_conf"]

    def group(base):
        return optax.adam(lambda count: base * sched(count / steps))
    opt = optax.multi_transform(
        {"mlp": group(float(lr["mlp_lr"])), "feat": group(float(lr["feat_lr"]))},
        {k: jax.tree.map(lambda _: "mlp" if k == "implicit_surface" else "feat", v)
         for k, v in params.items()})
    opt_state = opt.init(params)
    p_j = params
    for _ in range(2):
        upd, opt_state = opt.update(g_j, opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for path, t in _paths(trainer.params):
            t.grad = torch.from_numpy(np.array(_get(g_j, path)))
        trainer.update()
    for path, t in _paths(trainer.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(_get(p_j, path)),
                                   rtol=1e-5, atol=1e-8, err_msg=str(path))


def test_warmup_cosine_matches_jax():
    for total, warm, alpha in ((16, 1.0, 0.02), (2, 1.0, 0.02), (10, 0.2, 0.1)):
        js, ts = j_sched(total, warm, alpha), t_sched(total, warm, alpha)
        for e in np.linspace(0.0, total, 10, endpoint=False) + 0.37:
            np.testing.assert_allclose(ts(e), float(js(e)), rtol=1e-6, err_msg=str(e))


def test_checkpoints_load_bit_for_bit_both_ways(setup, tmp_path):
    tree = {"epoch": 3, "model": jax.tree.map(np.asarray, setup["params"]),
            "state": jax.tree.map(np.asarray, setup["state"]),
            "misc": {"pair": (np.arange(3), None), "flag": np.bool_(True)}}
    jpath, tpath = str(tmp_path / "j.ckpt.npz"), str(tmp_path / "t.ckpt.npz")
    jckpt.save_checkpoint(jpath, tree)
    from_j = tckpt.load_checkpoint(jpath)
    tckpt.save_checkpoint(tpath, from_j)
    from_t = jckpt.load_checkpoint(tpath)
    for a, b in ((from_j, tree), (from_t, tree)):
        pa, pb = _paths(a), _paths(b)
        assert [p for p, _ in pa] == [p for p, _ in pb]
        for (p, x), (_, y) in zip(pa, pb):
            if y is None:
                assert x is None, p
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))
                assert np.asarray(x).dtype == np.asarray(y).dtype, p
    assert isinstance(from_j["misc"]["pair"], tuple)
    # the port's own parameters round-trip through a checkpoint unchanged
    tp, _ = from_jax(tree["model"], tree["state"])
    back = tckpt.to_torch_tree(tckpt.load_checkpoint(jpath)["model"])
    for (p, x), (_, y) in zip(_paths(tp), _paths(back)):
        assert torch.equal(x, y), p


# -- optimizer-state resume (``--mode train --resume``) ---------------------------

def _sched(conf):
    return j_sched(conf.get_int("train.epochs"), conf.get_float("train.warmup"),
                   conf.get_float("train.alpha"))


def _runner_optimizer(conf, steps):
    """The JAX runner's own ``_make_optimizer`` and ``_label_fn`` on a
    stand-in for the runner (a Runner would back up the code tree and
    build its loaders)."""
    from types import SimpleNamespace
    from surf_tpu.runner import Runner
    ns = SimpleNamespace(_steps_per_epoch=steps, lr_conf=conf["train.lr_conf"],
                         _lr_scale=_sched(conf))
    ns._label_fn = lambda p: Runner._label_fn(ns, p)
    return Runner._make_optimizer(ns)


def _optax_steps(opt, params, grads, n, opt_state=None):
    opt_state = opt.init(params) if opt_state is None else opt_state
    for _ in range(n):
        upd, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
    return params, opt_state


def _set_grads(trainer, grads):
    for path, t in _paths(trainer.params):
        t.grad = torch.from_numpy(np.array(_get(grads, path)))


def test_train_resumes_from_a_jax_checkpoint(setup, tmp_path):
    """Runner.save's checkpoint after two optax updates: the port's Trainer
    restores parameters, moments, counts and schedule (start epoch 1), and
    its next update equals optax's third at the Adam test's tolerance
    (rtol 1e-5, atol 1e-8)."""
    from types import SimpleNamespace
    from surf_tpu.runner import Runner
    from surf_tpu_torch.utils.opt_state import leaves_with_path
    _, g_j, _, _, _, _ = _run(setup, "step1_dense")
    conf, params = setup["conf"], setup["params"]
    tconf = ConfigFactory.parse_string(TINY)
    steps = len(JDataset(conf["train_dataset"], "train"))
    opt = _runner_optimizer(conf, steps)
    p_j, s_j = _optax_steps(opt, params, g_j, 2)
    Runner.save(SimpleNamespace(is_main=True, base_exp_dir=str(tmp_path), params=p_j,
                                state=setup["state"], opt_state=s_j), 0)
    trainer = Trainer(tconf, device="cpu",
                      resume=str(tmp_path / "checkpoints" / "model_000.ckpt.npz"))
    assert trainer.start_epoch == 1 and trainer.scheduler.last_epoch == 2
    inner = s_j.inner_states
    for g in trainer.optimizer.param_groups:
        adam, sched = inner[g["name"]].inner_state
        assert int(sched.count) == 2
        np.testing.assert_allclose(
            g["lr"], float(conf["train.lr_conf"][f"{g['name']}_lr"])
            * float(_sched(conf)(2 / steps)), rtol=1e-6)
    for path, t in leaves_with_path(trainer.params):
        group = "mlp" if path[0] == "implicit_surface" else "feat"
        adam = inner[group].inner_state[0]
        st = trainer.optimizer.state[t]
        assert int(st["step"]) == int(adam.count) == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(_get(adam.mu, path)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(_get(adam.nu, path)))
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(_get(p_j, path)))
    p_j3, _ = _optax_steps(opt, p_j, g_j, 1, s_j)
    _set_grads(trainer, g_j)
    trainer.update()
    for path, t in _paths(trainer.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(_get(p_j3, path)),
                                   rtol=1e-5, atol=1e-8, err_msg=str(path))



def test_port_checkpoint_restores_under_the_jax_runner(setup, tmp_path):
    """The port's training checkpoint after two updates: its ``opt_struct``
    is the JAX runner's fingerprint character for character,
    ``_restore_opt_state`` accepts it, and the restored optax state equals
    optax's own after the same two updates (moments rtol 1e-5, counts
    exactly).  A changed fingerprint or leaf shape is refused by both."""
    from surf_tpu.runner import _opt_state_fingerprint, _restore_opt_state
    from surf_tpu_torch.utils.opt_state import leaves_with_path, restore_opt_state
    _, g_j, _, _, _, _ = _run(setup, "step1_dense")
    conf, params = setup["conf"], setup["params"]
    tconf = ConfigFactory.parse_string(TINY)
    tp, ts = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, setup["state"]))
    trainer = Trainer(tconf, device="cpu", params=tp, state=ts, base_exp_dir=str(tmp_path))
    for _ in range(2):
        _set_grads(trainer, g_j)
        trainer.update()
    path = trainer.save(0)
    ck = jckpt.load_checkpoint(path)
    opt = _runner_optimizer(conf, trainer.steps_per_epoch)
    assert str(ck["opt_struct"]) == _opt_state_fingerprint(opt.init(params))
    restored = _restore_opt_state(opt, params, ck["opt_state"], ck["opt_struct"])
    _, s_j = _optax_steps(opt, params, g_j, 2)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                          jax.tree.leaves(s_j)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(kp)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(kp))
    # refusals: a changed fingerprint, then a leaf of another shape
    bad = str(ck["opt_struct"]).replace(":(129,):", ":(128,):", 1)
    with pytest.raises(ValueError, match="structure changed"):
        _restore_opt_state(opt, params, ck["opt_state"], bad)
    with pytest.raises(ValueError, match="structure changed"):
        restore_opt_state(trainer.params, trainer.optimizer, trainer.scheduler,
                          tckpt.load_checkpoint(path)["opt_state"], bad)
    tree = tckpt.load_checkpoint(path)["opt_state"]
    leaf, _ = next(leaves_with_path(trainer.params["implicit_surface"]))
    node = tree[0]["mlp"][0][0][1]["implicit_surface"]       # mu
    for k in leaf[:-1]:
        node = node[k]
    node[leaf[-1]] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_opt_state(trainer.params, trainer.optimizer, trainer.scheduler, tree)
