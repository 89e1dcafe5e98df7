"""Port parity of the ray-sharded validate and the multi-process CLI, on
2 gloo ranks on the CPU (``parallel.distribute.spawn``, a ``file://``
rendezvous under the test's temporary directory).

The validate of the tiny model (JAX init, carried over by
``convert.from_jax``) with its render chunks (96 rays) and its SDF
lattice split across the 2 ranks: the image against JAX's render of the
same rays through ``shard_rays_jit`` over ``ray_mesh(jax.devices()[:2])``
and the lattice against ``surf_tpu.geometry.extract.extract_geometry(...,
ray_mesh=...)``, perturbation off, at tests/test_torch_validate.py's
tolerances (1e-4 relative, 1e-4 absolute); and against the port's
one-process validate of the same parameters bit for bit, with
``render.perturb`` 0 and 1 (the jitter of a chunk drawn whole on every
rank).  The CLI: ``--mode train --device cpu`` on 2 ranks writes each
epoch's checkpoint once (rank 0), every rank ends with the same
parameters and Adam moments, the ragged 3-item epoch takes 2 super-batches
(the second padded) and the schedule counts them as the JAX runner's
does; ``--resume`` goes on from the saved counts on both ranks; with
``train.data_parallel = false`` it refuses more than one rank."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tiny_conf import tiny_conf, TINY
import torch_parallel_workers as workers
from surf_tpu.data.synthetic import SyntheticDataset as JDataset
from surf_tpu.geometry.extract import extract_geometry as j_extract
from surf_tpu.nn import surf as jsurf, feature_net as jfn, implicit_surface as jis
from surf_tpu.nn import sdf_net as jsdf
from surf_tpu.nn.core import materialize_weight_norm as j_fold
from surf_tpu.parallel.ray_shard import ray_mesh, shard_rays_jit
from surf_tpu.utils import checkpoint as jckpt
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.parallel import distribute
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import save_checkpoint, to_numpy_tree
from surf_tpu_torch.validate import Validator

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

MESH_RES = 24
CHUNK = 96
RTOL, ATOL = 1e-4, 1e-4


def _conf_text(perturb):
    text = TINY.replace("perturb = 1.0", f"perturb = {perturb}").replace(
        "    val_freq = 10\n", f"    val_freq = 10\n    val_ray_chunk = {CHUNK}\n")
    assert "val_ray_chunk" in text and f"perturb = {perturb}" in text
    return text


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("val")
    conf = tiny_conf()
    params, state, static = jsurf.init(jax.random.PRNGKey(0), conf["model"])
    params_np, state_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    tp, ts = from_jax(params_np, state_np)
    ck = str(tmp / "params.ckpt.npz")
    save_checkpoint(ck, {"model": to_numpy_tree(tp), "state": to_numpy_tree(ts)})
    confs = [(f"p{p}", _conf_text(p)) for p in (0.0, 1.0)]
    # CPU kernels sum in an order that depends on their thread count: the
    # ranks and the one-process validate run with the same count
    threads = torch.get_num_threads()
    share = max(1, threads // 2)
    distribute.spawn(workers.sharded_validate, 2,
                     (f"file://{tmp}/rdzv", confs, ck, MESH_RES, str(tmp), share),
                     timeout=600)
    sharded = {name: [dict(np.load(tmp / f"{name}_rank{r}.npz")) for r in range(2)]
               for name, _ in confs}
    # the port's one-process validate of the same parameters
    single = {}
    torch.set_num_threads(share)
    try:
        for name, text in confs:
            tp, ts = from_jax(params_np, state_np)
            v = Validator(ConfigFactory.parse_string(text), device="cpu",
                          mesh_resolution=MESH_RES, base_exp_dir=str(tmp / f"single_{name}"),
                          params=tp, state=ts)
            got = workers.record_image_and_lattice(v)
            (m,) = v.validate()
            single[name] = (m, got)
    finally:
        torch.set_num_threads(threads)

    # JAX: the same rays over a 2-device ray mesh, the lattice with ray_mesh
    batch = JDataset(conf["val_dataset"], "val")[0]
    ipts = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, str)}
    feats = jax.jit(jfn.apply)(params["feature_network"], ipts["imgs"])
    _, stages, mv, _ = jsurf.build_volumes(
        jax.random.PRNGKey(1), params, state, static, ipts, feats, perturb=False,
        training=False, jit_stages=True)
    st_is = dict(static["implicit_surface"], perturb=0.0)
    mesh = ray_mesh(jax.devices()[:2])

    def render_chunk(p, key, ro, rd, mv, stages, ff):
        return jis.render(key, p, st_is, ro, rd, ipts["near"], ipts["far"], mv, stages, ff,
                          ff, ipts["imgs"], ipts["intrs"], ipts["c2ws"], 1.0, None)
    r = shard_rays_jit(render_chunk, mesh, 7, (2, 3))(
        params["implicit_surface"], jax.random.PRNGKey(2), ipts["rays_o"], ipts["rays_d"],
        mv, stages[::-1], feats[::-1])

    def sdf_chunk(p, stages, occ, pts):
        m = jis.occupancy_mask([g for g, _ in stages], pts)
        s = jsdf.sdf_only(p["sdf_network"], st_is["sdf"], pts, stages)
        return jnp.where(m[:, None], s, 100.0)[:, 0]
    _, _, u = j_extract(shard_rays_jit(sdf_chunk, mesh, 4, (3,)),
                        j_fold(params["implicit_surface"]), stages[::-1], MESH_RES,
                        block=16, ray_mesh=mesh)
    h, w = [int(x) for x in np.asarray(batch["hw"]).reshape(-1)]
    normal = (np.asarray(r["gradients"]) * np.asarray(r["weights"])[..., None]
              * np.asarray(r["inside_sphere"])[..., None]).sum(1)
    rot = np.linalg.inv(np.asarray(batch["c2ws"])[0, :3, :3])
    ref = {"color": np.asarray(r["color_fine"]).reshape(h, w, 3),
           "normal": (rot @ normal.T).T.reshape(h, w, 3),
           "sdf_depth": np.asarray(r["sdf_depth"]).reshape(h, w),
           "render_depth": np.asarray(r["render_depth"]).reshape(h, w),
           "lattice": np.asarray(u)}
    return dict(sharded=sharded, single=single, jax=ref)


def test_sharded_validate_matches_jax_ray_mesh(val):
    got = val["sharded"]["p0.0"][0]
    for k, ref in val["jax"].items():
        np.testing.assert_allclose(got[k], ref, rtol=RTOL, atol=ATOL, err_msg=k)
    assert (got["lattice"] < 100).sum() > 0 and got["mesh_faces"] > 0


@pytest.mark.parametrize("name", ["p0.0", "p1.0"])
def test_sharded_validate_equals_one_process_bit_for_bit(val, name):
    r0, r1 = val["sharded"][name]
    m, got = val["single"][name]
    for k, a in zip(workers.IMAGE_KEYS, got["image"]):
        np.testing.assert_array_equal(r0[k], a, err_msg=k)
    np.testing.assert_array_equal(r0["lattice"], got["lattice"][2])
    # every rank returns the node's metrics; only the first holds the image
    for r in (r0, r1):
        assert r["psnr"] == m["psnr"] and r["mesh_faces"] == m["mesh_faces"] > 0
        assert r["mesh_vertices"] == m["mesh_vertices"]
    assert "color" not in r1


def test_perturbation_moves_the_sharded_render(val):
    a, b = val["sharded"]["p0.0"][0], val["sharded"]["p1.0"][0]
    assert not np.array_equal(a["render_depth"], b["render_depth"])
    np.testing.assert_array_equal(a["lattice"], b["lattice"])


def _cli_conf(tmp_path):
    text = TINY.replace("n_scenes = 2\n    n_views_total = 6",
                        "n_scenes = 1\n    n_views_total = 3", 1)
    assert text != TINY
    path = tmp_path / "tiny.conf"
    path.write_text(text)
    return path


def _train(tmp_path, out, extra=()):
    args = ["--conf", str(_cli_conf(tmp_path)), "--mode", "train", "--device", "cpu",
            "--out", str(out), *extra]
    distribute.spawn(workers.cli, 2, (f"file://{out}.rdzv", args, str(out)), timeout=600)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_cli_train_on_two_ranks_and_resume(tmp_path):
    a = _train(tmp_path, tmp_path / "a")
    # one checkpoint an epoch, written once
    assert sorted(p.name for p in (tmp_path / "a" / "checkpoints").iterdir()) == \
        ["model_000.ckpt.npz", "model_001.ckpt.npz"]
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], a[1][k], err_msg=k)
    # 3 items on 2 ranks: 2 super-batches an epoch, the second padded; the
    # schedule counts super-batches over len(dataset), as the JAX runner's
    # optax count over len(train_loader)
    n_items, n = 3, 2
    assert int(a[0]["last_epoch"]) == 2 * n
    conf = tiny_conf()
    sched = j_sched(conf.get_int("train.epochs"), conf.get_float("train.warmup"),
                    conf.get_float("train.alpha"))
    lr = conf["train.lr_conf"]
    np.testing.assert_allclose(a[0]["lrs"], [float(lr["mlp_lr"]) * float(sched(2 * n / n_items)),
                                             float(lr["feat_lr"]) * float(sched(2 * n / n_items))],
                               rtol=1e-6)
    ck = jckpt.load_checkpoint(str(tmp_path / "a" / "checkpoints" / "model_000.ckpt.npz"))
    adam, sched_state = ck["opt_state"][0]["mlp"][0]
    assert int(adam[0]) == int(sched_state[0]) == n
    final = jckpt.load_checkpoint(str(tmp_path / "a" / "checkpoints" / "model_001.ckpt.npz"))
    for path, t in workers.paths(final["model"]):
        np.testing.assert_array_equal(a[0][workers.key("p.", path)], t, err_msg=str(path))

    b = _train(tmp_path, tmp_path / "b",
               ["--resume", str(tmp_path / "a" / "checkpoints" / "model_000.ckpt.npz")])
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints").iterdir()) == \
        ["model_001.ckpt.npz"]
    for r in b:
        assert int(r["start_epoch"]) == 1 and int(r["last_epoch"]) == 2 * n
    for k in b[0]:
        np.testing.assert_array_equal(b[0][k], b[1][k], err_msg=k)
    ck = jckpt.load_checkpoint(str(tmp_path / "b" / "checkpoints" / "model_001.ckpt.npz"))
    adam, sched_state = ck["opt_state"][0]["mlp"][0]
    assert int(adam[0]) == int(sched_state[0]) == 2 * n


def test_cli_train_on_two_ranks_refuses_without_data_parallel(tmp_path):
    text = _cli_conf(tmp_path).read_text().replace(
        "    save_freq = 1\n", "    save_freq = 1\n    data_parallel = false\n", 1)
    assert "data_parallel = false" in text
    conf = tmp_path / "no_dp.conf"
    conf.write_text(text)
    out = tmp_path / "no_dp"
    args = ["--conf", str(conf), "--mode", "train", "--device", "cpu", "--out", str(out)]
    distribute.spawn(workers.cli_refused, 2, (f"file://{out}.rdzv", args, str(out)),
                     timeout=600)
    for r in range(2):
        assert "train.data_parallel = true" in (out / f"refused{r}.txt").read_text()
    assert not (out / "checkpoints").exists()
    # one process trains with it false, as before
    t = Trainer(ConfigFactory.parse_string(text), device="cpu", base_exp_dir=str(out))
    assert not t.data_parallel
