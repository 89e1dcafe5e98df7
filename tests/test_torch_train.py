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
(params within 1e-5 relative), the schedule at 10 fractional epochs, and
the npz checkpoint layout read bit for bit by the other package."""

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


def test_trainer_loop_refreshes_and_saves_a_checkpoint(tmp_path):
    """``Trainer.train`` over a cut dataset: the frozen matching copy is
    refreshed on the even epoch, the loss stays finite, and the saved
    checkpoint loads in the JAX package with the trained parameters."""
    tconf = ConfigFactory.parse_string(TINY)
    tconf["train"]["epochs"] = 1
    trainer = Trainer(tconf, device="cpu", base_exp_dir=str(tmp_path))
    trainer.dataset.metas = trainer.dataset.metas[:2]
    trainer.state["match_feature_network"] = jax.tree.map(
        lambda t: t * 0.0, trainer.state["match_feature_network"])
    before = [t.detach().clone() for _, t in _paths(trainer.params)]
    trainer.train()
    ck = jckpt.load_checkpoint(str(tmp_path / "checkpoints" / "model_000.ckpt.npz"))
    assert int(ck["epoch"]) == 0
    moved = 0
    for (path, t), b in zip(_paths(trainer.params), before):
        np.testing.assert_array_equal(np.asarray(_get(ck["model"], path)),
                                      t.detach().numpy(), err_msg=str(path))
        moved += not torch.equal(t.detach(), b)
    assert moved == len(before)
    for (path, a), (_, b) in zip(_paths(ck["state"]["match_feature_network"]),
                                 _paths(ck["model"]["feature_network"])):
        assert np.abs(a).max() > 0, path

