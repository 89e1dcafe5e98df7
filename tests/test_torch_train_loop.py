"""Port parity of the training loop and its CLI, split from
tests/test_torch_train.py (whose module fixture compiles the JAX
reference step) so that the suite's workers run the two files side by
side: ``Trainer.train`` over a cut dataset (the frozen matching copy
refreshed, the checkpoint read by the JAX package with the trained
parameters), its validate every ``val_freq`` epochs after the save (the
artifacts equal to a ``Validator``'s built afterwards), and
``--mode train --resume`` through the CLI (the run goes on from the saved
epoch with the saved Adam counts and writes a checkpoint that the JAX
runner's ``_restore_opt_state`` accepts)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tiny_conf import tiny_conf, TINY
from surf_tpu.utils import checkpoint as jckpt
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.io import read_png
from surf_tpu_torch.train import Trainer

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)


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


def _runner_optimizer(conf, steps):
    """The JAX runner's own ``_make_optimizer`` and ``_label_fn`` on a
    stand-in for the runner (a Runner would back up the code tree and
    build its loaders)."""
    from types import SimpleNamespace
    from surf_tpu.runner import Runner
    sched = j_sched(conf.get_int("train.epochs"), conf.get_float("train.warmup"),
                    conf.get_float("train.alpha"))
    ns = SimpleNamespace(_steps_per_epoch=steps, lr_conf=conf["train.lr_conf"],
                         _lr_scale=sched)
    ns._label_fn = lambda p: Runner._label_fn(ns, p)
    return Runner._make_optimizer(ns)


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
    # the tiny conf's val_freq (10) is past the one epoch: nothing validated
    assert not (tmp_path / "meshes").exists()
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


def test_trainer_validates_every_val_freq_epochs_after_the_save(tmp_path):
    """With ``val_freq`` 1, ``Trainer.train`` validates after the epoch's
    save: the mesh and the ``val_*`` files under the names
    ``Validator.validate`` gives them, equal to those of a ``Validator``
    built afterwards on the trained parameters and state, with the same
    PSNR."""
    from surf_tpu_torch.validate import Validator
    tconf = ConfigFactory.parse_string(TINY)
    tconf["train"]["epochs"] = 1
    tconf["train"]["val_freq"] = 1
    out = tmp_path / "train"
    trainer = Trainer(tconf, device="cpu", base_exp_dir=str(out), mesh_resolution=24)
    trainer.dataset.metas = trainer.dataset.metas[:1]
    seen, validate = [], trainer.validate

    def recorded(val, epoch):
        assert (out / "checkpoints" / f"model_{epoch:0>3}.ckpt.npz").exists()
        seen.append((epoch, validate(val, epoch)))
        return seen[-1][1]
    trainer.validate = recorded
    trainer.train()
    assert [e for e, _ in seen] == [0]
    ref_dir = tmp_path / "ref"
    v = Validator(tconf, device="cpu", mesh_resolution=24, base_exp_dir=str(ref_dir),
                  params=trainer.params, state=trainer.state)
    with torch.no_grad():
        ref = v.validate(0)
    got = seen[0][1]
    assert [m["scene"] for m in got] == [m["scene"] for m in ref]
    for a, b in zip(got, ref):
        assert a["psnr"] == b["psnr"] and a["mesh_faces"] == b["mesh_faces"] > 0
        scene = a["scene"]
        assert (out / "meshes" / f"{scene}_epoch0.ply").read_bytes() == \
            (ref_dir / "meshes" / f"{scene}_epoch0.ply").read_bytes()
    for sub in ("val_img", "val_normal", "val_render_depth", "val_sdf_depth",
                "val_auxi_depth"):
        names = sorted(p.name for p in (ref_dir / sub).iterdir())
        # Runner.validate's artifacts: 8-bit PNGs of colour and normal, each
        # depth as a magma PNG and its .npy
        stems = {n[:n.rindex(".")] for n in names}
        exts = (".png",) if sub in ("val_img", "val_normal") else (".npy", ".png")
        assert stems and all(st.endswith("_epoch0") for st in stems), sub
        assert names == sorted(st + e for st in stems for e in exts), sub
        assert sorted(p.name for p in (out / sub).iterdir()) == names, sub
        for n in names:
            load = np.load if n.endswith(".npy") else lambda p: read_png(str(p))
            np.testing.assert_array_equal(load(out / sub / n), load(ref_dir / sub / n))


def test_train_resume_through_the_cli(tmp_path):
    """``--mode train --resume``: a run from epoch 0's checkpoint trains
    epoch 1 only, its optimizer going on from the saved counts, and writes
    a checkpoint the JAX runner's ``_restore_opt_state`` accepts."""
    from surf_tpu.runner import _restore_opt_state
    from surf_tpu_torch import main
    text = TINY.replace("n_scenes = 2\n    n_views_total = 6",
                        "n_scenes = 1\n    n_views_total = 3", 1)
    assert text != TINY
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(text)
    first = main.main(["--conf", str(conf_path), "--mode", "train", "--device", "cpu",
                       "--out", str(tmp_path / "a")])
    n = first.steps_per_epoch
    assert n == 3 and first.scheduler.last_epoch == 2 * n
    ckpt0 = tmp_path / "a" / "checkpoints" / "model_000.ckpt.npz"
    resumed = main.main(["--conf", str(conf_path), "--mode", "train", "--device", "cpu",
                         "--out", str(tmp_path / "b"), "--resume", str(ckpt0)])
    assert resumed.start_epoch == 1
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints").iterdir()) == \
        ["model_001.ckpt.npz"]
    ck = jckpt.load_checkpoint(str(tmp_path / "b" / "checkpoints" / "model_001.ckpt.npz"))
    assert int(ck["epoch"]) == 1
    adam, sched = ck["opt_state"][0]["mlp"][0]
    assert int(adam[0]) == int(sched[0]) == 2 * n
    jconf = tiny_conf()
    params = jax.tree.map(jnp.asarray, ck["model"])
    _restore_opt_state(_runner_optimizer(jconf, n), params, ck["opt_state"],
                       ck["opt_struct"])
