"""Port parity of the finetune slice (``surf_tpu_torch.finetune``) against
the JAX runner's finetune (surf_tpu/runner.py:706-882), on the tiny
2-stage configuration with the synthetic finetune scene, on the CPU:

* ``init_volumes``: the cascade over all views against
  ``surf.build_volumes``; stages keyed by voxel coordinate (compaction
  may permute rows), storages and matching volume within 1e-5, the FPN
  features within 1e-4 (as tests/test_torch_validate.py holds them);
* one step on the JAX volumes carried across, z jitter off, the same 1024
  probe points: every loss term within rtol 1e-4 / atol 1e-5 of
  ``jax.value_and_grad`` of the loss as runner.py:775-793 writes it;
  every implicit-surface leaf and every stage's storage gradient within
  1e-3 of its largest JAX entry + 1e-6 (sums in another order through
  three orders of differentiation, as tests/test_torch_train.py states);
* three optimizer updates against ``optax.multi_transform`` of one Adam
  per group at ``base * lr_scale(count)``: the raw step count and the
  per-stage learning rates, params within 1e-5 relative plus 1e-4 of the
  updates' size (optax's f32 bias corrections);
* the host stream: the first 8 (view, rays, pseudo points) of the loop
  equal the JAX runner's for seed 0, bit for bit;
* checkpoints: a JAX finetune checkpoint with a bf16 matching volume is
  read bit for bit, the port writes the same members byte for byte, and
  a ``--load_vol`` resume keeps the volumes bit for bit;
* the CLI end to end: ``--mode finetune`` (2 steps, the step -1 mesh, a
  checkpoint), a ``--load_vol`` resume that takes one more step, and
  ``--mode val --load_vol``.
"""

import os
import types
import zipfile

import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tiny_conf import TINY
from surf_tpu.config import ConfigFactory as JConfigFactory
from surf_tpu.data.dtu_finetune import SyntheticDatasetFinetune as JFinetuneData
from surf_tpu.losses import compute_loss as j_loss, make_loss_config as j_cfg
from surf_tpu.nn import surf as jsurf, feature_net as jfeat, implicit_surface as jis
from surf_tpu.utils import checkpoint as jckpt
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.data import SyntheticDatasetFinetune
from surf_tpu_torch.finetune import Finetuner
from surf_tpu_torch.main import main
from surf_tpu_torch.utils import load_checkpoint, resume_from, vol_state_from_tree
from surf_tpu_torch.validate import to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

FT_BLOCK = """
finetune_dataset {
    dataset_name = SyntheticDatasetFinetune
    scene = syn0
    ref_view = 0
    num_src_view = 2
    img_hw = [64, 80]
    n_rays = 64
    val_res_level = 8
    n_views_total = 6
}
"""
CONF = TINY + FT_BLOCK
STEP = 1


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jconf = JConfigFactory.parse_string(CONF)
    params, state, static = jsurf.init(jax.random.PRNGKey(0), jconf["model"])
    # geometric init starts the SDF net's feature-input rows at zero, which
    # would make every storage gradient 0: give them values, as training does
    rng = np.random.RandomState(4)
    n_feat = jconf.get_int("model.implicit_surface.sdf_network.feat_channels")
    for lin in params["implicit_surface"]["sdf_network"]["layers"][:-1]:
        lin["v"] = lin["v"].at[-n_feat:].add(
            jnp.asarray(rng.randn(n_feat, lin["v"].shape[1]) * 0.02, jnp.float32))
    jds = JFinetuneData(jconf["finetune_dataset"])
    ipts = {k: jnp.asarray(v) for k, v in jds.get_all_images().items()}
    features = jfeat.apply(params["feature_network"], ipts["imgs"])
    _, stages, matching, _ = jsurf.build_volumes(
        jax.random.PRNGKey(1), params, state, static, ipts, features,
        perturb=False, training=False)
    vol_state = {"volumes": [s for _, s in stages], "grids": [g for g, _ in stages],
                 "matching_volume": matching, "features": list(features)}
    tp, ts = from_jax(_np_tree(params), _np_tree(state))
    ft = Finetuner(ConfigFactory.parse_string(CONF), device="cpu", params=tp, state=ts,
                   base_exp_dir=str(tmp_path_factory.mktemp("ft")))
    return dict(jconf=jconf, params=params, state=state, static=static, jds=jds,
                vol_state=vol_state, ft=ft, results={})


def _keyed(grid, storage):
    """Active voxels sorted by linear coordinate, and their storage rows."""
    cc = np.asarray(grid.child_coords())
    live = np.asarray(grid.cvalid)
    lin = (cc[:, 0] * grid.res + cc[:, 1]) * grid.res + cc[:, 2]
    order = np.argsort(lin[live])
    return lin[live][order], np.asarray(storage)[live][order]


def test_init_volumes_match_jax(setup):
    vs_j, vs_t = setup["vol_state"], setup["ft"].vol_state
    assert len(vs_t["grids"]) == len(vs_j["grids"]) == 2
    for g_j, s_j, g_t, s_t in zip(vs_j["grids"], vs_j["volumes"], vs_t["grids"],
                                  vs_t["volumes"]):
        lin_j, rows_j = _keyed(g_j, s_j)
        lin_t, rows_t = _keyed(g_t, s_t.detach())
        assert len(lin_j) > 0
        np.testing.assert_array_equal(lin_t, lin_j)
        np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=1e-5)
        assert s_t.requires_grad and s_t.is_leaf
    np.testing.assert_allclose(vs_t["matching_volume"].numpy(),
                               np.asarray(vs_j["matching_volume"]), rtol=0, atol=1e-5)
    # the FPN's five convolutions and instance norms sum in another order
    # than XLA's: 1e-4, as tests/test_torch_validate.py holds the features
    for f_t, f_j in zip(vs_t["features"], vs_j["features"]):
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4, atol=1e-4)


def _carried(setup, vol_state=None):
    """A Finetuner on the JAX vol_state (or ``vol_state``) carried across."""
    ft = setup["ft"]
    ft.vol_state = vol_state_from_tree(_np_tree({
        "volumes": setup["vol_state"]["volumes"],
        "grids": [tuple(g) for g in setup["vol_state"]["grids"]],
        "matching_volume": setup["vol_state"]["matching_volume"],
        "features": setup["vol_state"]["features"]})) if vol_state is None else vol_state
    tp, _ = from_jax(_np_tree(setup["params"]), _np_tree(setup["state"]))
    ft.params["implicit_surface"] = tp["implicit_surface"]
    ft.init_volumes()
    return ft


def _step(setup):
    """One step on both sides: (terms_j, grads_j, terms_t, finetuner)."""
    if "step" in setup["results"]:
        return setup["results"]["step"]
    jconf, static, vs = setup["jconf"], setup["static"], setup["vol_state"]
    batch = setup["jds"].get_random_rays(1, rng=np.random.RandomState(3))
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    pts_random = np.array(jax.random.uniform(jax.random.split(key)[1], (1024, 3))
                          * 2.0 - 1.0)
    isf_static = dict(static["implicit_surface"], perturb=0.0)
    cfg = j_cfg(jconf["train.loss"])
    anneal = min(1.0, STEP / jconf.get_float("train.anneal_end"))

    def loss_fn(p):
        stages_ff = list(zip(vs["grids"], p["volumes"]))[::-1]
        feats_ff = [jnp.take(f, bj["view_ids"], axis=0) for f in vs["features"]][::-1]
        out = jis.render(key, p["implicit_surface"], isf_static, bj["rays_o"], bj["rays_d"],
                         bj["near"], bj["far"], vs["matching_volume"], stages_ff, feats_ff,
                         feats_ff, bj["imgs"], bj["intrs"], bj["c2ws"], anneal, float(STEP))
        out["pseudo_sdf"] = jis.pseudo_sdf(p["implicit_surface"], isf_static,
                                           bj["pseudo_pts"], stages_ff)
        res = j_loss(cfg, out, bj, float(STEP), "finetune")
        res["psnr"] = 20.0 * jnp.log10(1.0 / jnp.sqrt(
            jnp.mean((out["color_fine"] - bj["color"]) ** 2)))
        return res["loss"], res

    p_j = {"implicit_surface": setup["params"]["implicit_surface"],
           "volumes": list(vs["volumes"])}
    (_, res_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p_j)

    ft = _carried(setup)
    ft.static["implicit_surface"] = dict(ft.static["implicit_surface"], perturb=0.0)
    ft.optimizer.zero_grad(set_to_none=True)
    res_t = ft.loss(to_device(batch, "cpu"), STEP, pts_random=torch.from_numpy(pts_random))
    res_t["loss"].backward()
    setup["results"]["step"] = (res_j, g_j, res_t, ft)
    return setup["results"]["step"]


def test_finetune_step_loss_terms_match_jax(setup):
    res_j, _, res_t, _ = _step(setup)
    assert set(res_j) == set(res_t)
    for k in res_j:
        got = float(res_t[k].detach()) if torch.is_tensor(res_t[k]) else float(res_t[k])
        np.testing.assert_allclose(got, float(res_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    # the finetune mode's terms: no photometric or matching-field depth loss
    assert float(res_j["photo_loss"]) == 0.0 and float(res_j["pseudo_depth_loss"]) > 0
    assert float(res_j["mfc_loss"]) != 0.0 and float(res_j["pseudo_sdf_loss"]) > 0


def test_finetune_step_gradients_match_jax(setup):
    _, g_j, _, ft = _step(setup)
    leaves = [(("implicit_surface",) + p, t)
              for p, t in _paths(ft.params["implicit_surface"])]
    leaves += [(("volumes", i), v) for i, v in enumerate(ft.vol_state["volumes"])]
    assert len(leaves) == len(jax.tree.leaves(g_j))
    nonzero = 0
    for path, t in leaves:
        ref = np.asarray(_get(g_j, path))
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(ref)
        assert got.shape == ref.shape, path
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-3 * scale + 1e-6, path
        nonzero += scale > 1e-6
    assert nonzero > 0.9 * len(leaves)
    # K3b's storage gradient reaches every stage
    for i in range(2):
        assert np.abs(np.asarray(g_j["volumes"][i])).max() > 0


def test_finetune_optimizer_matches_optax(setup):
    """Three updates: one Adam per group (the implicit surface at mlp_lr,
    stage i at vol_lr[i]) under the warmup-cosine of the raw step count."""
    _, g_j, _, _ = _step(setup)
    jconf = setup["jconf"]
    ft = _carried(setup)
    sched = j_sched(jconf.get_int("train.epochs"), jconf.get_float("train.warmup"),
                    jconf.get_float("train.alpha"))
    assert [sched(c) for c in range(3)] == pytest.approx([0.1, 1.0, 0.02], rel=1e-6)
    vol_lrs = [1e-1, 1e-2, 1e-2, 1e-3]

    def adam(base):
        return optax.adam(lambda count: base * sched(count))
    transforms = {"mlp": adam(float(jconf["train.lr_conf.mlp_lr"])),
                  "vol0": adam(vol_lrs[0]), "vol1": adam(vol_lrs[1])}
    p_j = {"implicit_surface": setup["params"]["implicit_surface"],
           "volumes": list(setup["vol_state"]["volumes"])}
    labels = {"implicit_surface": jax.tree.map(lambda _: "mlp", p_j["implicit_surface"]),
              "volumes": ["vol0", "vol1"]}
    opt = optax.multi_transform(transforms, labels)
    opt_state = opt.init(p_j)
    assert [g["name"] for g in ft.optimizer.param_groups] == ["mlp", "vol0", "vol1"]
    t_leaves = [(("implicit_surface",) + p, t)
                for p, t in _paths(ft.params["implicit_surface"])]
    t_leaves += [(("volumes", i), v) for i, v in enumerate(ft.vol_state["volumes"])]
    for _ in range(3):
        upd, opt_state = opt.update(g_j, opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for path, t in t_leaves:
            t.grad = torch.from_numpy(np.array(_get(g_j, path)))
        ft.update()
    # optax forms the bias corrections 1 - beta^k in f32, which cancels to
    # ~3e-5 of their value at k <= 3 (torch in f64): the updates agree to
    # 1e-4 of their size, at most the group's LR times the schedule's sum
    lrs = {"mlp": float(jconf["train.lr_conf.mlp_lr"]), 0: vol_lrs[0], 1: vol_lrs[1]}
    total = sum(sched(c) for c in range(3))
    for path, t in t_leaves:
        lr = lrs["mlp" if path[0] == "implicit_surface" else path[1]]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(_get(p_j, path)),
                                   rtol=1e-5, atol=1e-4 * lr * total, err_msg=str(path))


def _jax_runner_sequence(jconf, n):
    """The first ``n`` batches the JAX runner's finetune loop draws for
    seed 0 (its loop as it stands, the step function replaced by a
    recorder)."""
    from surf_tpu.runner import Runner
    seen = []

    def record(ft_params, opt_state, batch, key, step_f, anneal):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return ft_params, opt_state, {"loss": 0.0, "psnr": 0.0}

    r = Runner.__new__(Runner)
    r.conf, r.finetune_dataset = jconf, JFinetuneData(jconf["finetune_dataset"])
    r.host_rng, r.key = np.random.RandomState(0), jax.random.PRNGKey(0)
    r.start_epoch, r.epochs, r.anneal_end = 0, n, 0.0
    r.log_freq = r.save_freq = r.val_freq = 10 ** 9
    r.ft_params = r.ft_opt_state = None
    r.writer = types.SimpleNamespace(add_scalar=lambda *a, **k: None)
    r._finetune_step_fn = lambda: record
    r.save_finetune = r.validate_finetune = lambda step: None
    r.finetune()
    return seen


def test_host_sequence_matches_the_jax_runner(setup, tmp_path):
    n = 8
    ref = _jax_runner_sequence(setup["jconf"], n)
    tp, ts = from_jax(_np_tree(setup["params"]), _np_tree(setup["state"]))
    conf = ConfigFactory.parse_string(CONF)
    conf["train"]["epochs"] = n
    ft = Finetuner(conf, device="cpu", seed=0, params=tp, state=ts, base_exp_dir=str(tmp_path))
    seen = []
    ft.step = lambda batch, step: seen.append(batch) or {"loss": 0.0, "psnr": 0.0}
    ft.save_freq = ft.val_freq = 10 ** 9
    ft.save_finetune = ft.validate_finetune = lambda step: None
    ft.finetune()
    assert len(seen) == len(ref) == n
    assert len({int(b["view_ids"][0]) for b in ref}) == 3      # every view comes round
    for b_t, b_j in zip(seen, ref):
        for k in ("view_ids", "rays_o", "rays_d", "pseudo_pts", "color"):
            np.testing.assert_array_equal(b_t[k].numpy(), b_j[k], err_msg=k)


def _bf16_vol_state(setup):
    vs = setup["vol_state"]
    return {"volumes": vs["volumes"], "grids": vs["grids"],
            "matching_volume": vs["matching_volume"].astype(jnp.bfloat16),
            "features": vs["features"]}


def test_jax_finetune_checkpoint_reads_bit_for_bit(setup, tmp_path):
    vs = _bf16_vol_state(setup)
    path = str(tmp_path / "model_003.ckpt.npz")
    jckpt.save_checkpoint(path, {"epoch": 3, "model": {
        "vol_state": _np_tree(vs),
        "implicit_surface": _np_tree(setup["params"]["implicit_surface"])}})
    ft = setup["ft"]
    params, _, got = resume_from(path, ft.params, ft.state, load_vol=True)
    assert got["matching_volume"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["matching_volume"].view(torch.int16).numpy(),
                                  np.asarray(vs["matching_volume"]).view(np.int16))
    for name in ("volumes", "features"):
        for a, b in zip(got[name], vs[name]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for g_t, g_j in zip(got["grids"], vs["grids"]):
        assert g_t.parents.dtype == torch.int64 and g_t.res == g_j.res
        for a, b in zip(g_t, g_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for (p, a), (_, b) in zip(_paths(params["implicit_surface"]),
                              _paths(setup["params"]["implicit_surface"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(p))


def test_port_finetune_checkpoint_is_the_jax_layout(setup, tmp_path):
    """``save_finetune`` of the JAX state carried across writes the members
    the JAX runner's ``save_finetune`` writes, byte for byte (bf16 as
    '<V2'); a ``--load_vol`` resume keeps the volumes bit for bit."""
    vs = _bf16_vol_state(setup)
    ft = _carried(setup, vol_state_from_tree(_np_tree(
        dict(vs, grids=[tuple(g) for g in vs["grids"]]))))
    t_path = ft.save_finetune(7)
    j_path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(j_path, {"epoch": 7, "model": {
        "vol_state": jax.tree.map(np.asarray, {
            "volumes": vs["volumes"], "grids": vs["grids"],
            "matching_volume": vs["matching_volume"], "features": vs["features"]}),
        "implicit_surface": _np_tree(setup["params"]["implicit_surface"])}})
    zt, zj = zipfile.ZipFile(t_path), zipfile.ZipFile(j_path)
    # (JAX's tree maps sort dict keys: the members come in another order)
    assert sorted(zt.namelist()) == sorted(zj.namelist())
    for name in zj.namelist():
        assert zt.read(name) == zj.read(name), name
    mv = load_checkpoint(t_path)["model"]["vol_state"]["matching_volume"]
    assert mv.dtype.str == "|V2" and np.asarray(vs["matching_volume"]).dtype == ml_dtypes.bfloat16

    # --load_vol: the stored volumes and surface come back as they were
    conf = ConfigFactory.parse_string(CONF)
    back = Finetuner(conf, device="cpu", resume=t_path, load_vol=True,
                     base_exp_dir=str(tmp_path / "resumed"))
    for a, b in zip(back.vol_state["volumes"], ft.vol_state["volumes"]):
        assert torch.equal(a.detach(), b.detach())
    assert torch.equal(back.vol_state["matching_volume"], ft.vol_state["matching_volume"])
    for (p, a), (_, b) in zip(_paths(back.params["implicit_surface"]),
                              _paths(ft.params["implicit_surface"])):
        assert torch.equal(a.detach(), b.detach()), p


def test_finetune_cli_end_to_end(tmp_path):
    """``main --mode finetune --device cpu``: from a training checkpoint, 2
    steps with the step -1 mesh and a checkpoint; a ``--load_vol`` resume
    that takes one more step on the saved volumes; ``--mode val
    --load_vol`` on the same checkpoint.  Train ``--resume`` of a
    checkpoint of the conf's last epoch trains no further; finetune
    without ``--resume`` is refused."""
    from surf_tpu_torch.train import Trainer
    base = CONF.replace("./exp/tiny", str(tmp_path / "exp"))
    first = base.replace("val_freq = 10", "val_freq = 1000\n    val_before_finetune = true"
                         ).replace("save_freq = 1", "save_freq = 2")
    again = base.replace("epochs = 2", "epochs = 1").replace("val_freq = 10", "val_freq = 1000"
                                                             ).replace("warmup = 1", "warmup = 0")
    paths = {}
    for name, text in (("first", first), ("again", again)):
        paths[name] = str(tmp_path / f"{name}.conf")
        with open(paths[name], "w") as f:
            f.write(text)
    ckpt = Trainer(ConfigFactory.parse_string(base), device="cpu",
                   base_exp_dir=str(tmp_path / "train")).save(0)
    args = ["--device", "cpu", "--mesh_resolution", "24", "--out", str(tmp_path / "out")]
    ft = main(["--conf", paths["first"], "--mode", "finetune", "--resume", ckpt] + args)
    meshes = os.listdir(os.path.join(ft.base_exp_dir, "meshes"))
    assert any("step-1" in m for m in meshes) and any("step1" in m for m in meshes), meshes
    saved = os.path.join(ft.base_exp_dir, "checkpoints", "model_001.ckpt.npz")
    assert os.path.exists(saved)
    assert ft.base_exp_dir == os.path.join(str(tmp_path / "out"), "syn0", "view0")

    again_ft = Finetuner(ConfigFactory.parse_string(again), device="cpu", resume=saved,
                         load_vol=True, base_exp_dir=str(tmp_path / "again"),
                         mesh_resolution=24)
    for a, b in zip(again_ft.vol_state["volumes"], ft.vol_state["volumes"]):
        assert torch.equal(a.detach(), b.detach())
    before = [v.detach().clone() for v in again_ft.vol_state["volumes"]]
    again_ft.finetune()
    assert all(not torch.equal(a, v.detach())
               for a, v in zip(before, again_ft.vol_state["volumes"]))
    assert os.path.exists(os.path.join(again_ft.base_exp_dir, "checkpoints",
                                       "model_000.ckpt.npz"))

    res = main(["--conf", paths["again"], "--mode", "val", "--resume", saved, "--load_vol"]
               + args)
    assert res[0]["finite"] and np.isfinite(res[0]["psnr"])
    # train --resume goes on from the epoch after the saved one: here the
    # conf's last epoch was saved, so nothing is left to train
    resumed = main(["--conf", paths["again"], "--mode", "train", "--resume", ckpt] + args)
    assert resumed.start_epoch == 1 == resumed.epochs
    assert not os.path.exists(os.path.join(str(tmp_path / "out"), "checkpoints"))
    with pytest.raises(SystemExit):
        main(["--conf", paths["again"], "--mode", "finetune"] + args)


def test_finetune_dataset_matches_jax():
    """The port's ``SyntheticDatasetFinetune`` against the JAX package's:
    every array of ``get_all_images``, ``get_random_rays`` and
    ``get_rays_at`` equal bit for bit."""
    jconf = JConfigFactory.parse_string(CONF)
    j, t = (JFinetuneData(jconf["finetune_dataset"]),
            SyntheticDatasetFinetune(ConfigFactory.parse_string(CONF)["finetune_dataset"]))
    assert (t.num_views, t.scene) == (j.num_views, j.scene)
    for a, b in ((t.get_all_images(), j.get_all_images()),
                 (t.get_random_rays(2, rng=np.random.RandomState(1)),
                  j.get_random_rays(2, rng=np.random.RandomState(1))),
                 (t.get_rays_at(0), j.get_rays_at(0))):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], str):
                assert a[k] == b[k]
            else:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
