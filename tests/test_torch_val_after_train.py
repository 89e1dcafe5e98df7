"""The validate after training, on the CPU at the tiny size, against the
JAX runner's.

The port's ``Trainer`` and the JAX ``Runner`` train the tiny conf for its
2 epochs from the same initial weights (the port's seeded init, saved and
resumed by the runner; the runner in one process, as the port's trainer,
not over the tests' 8 virtual devices), and each validates its own
weights before and after.  The render is unperturbed
(``render.perturb = 0``), so a validate draws no jitter and renders the
same weights to the same view in either package.
``val_after_train.view_metrics`` splits each validated view into the
part inside the reference view's mask and the part outside it.

* The JAX runner's validate of the port's trained weights (its dense
  render storage in f32) gives the port's view metrics at 1e-4 relative
  with a 1e-4 floor, as tests/test_torch_validate.py holds a render: a
  fault in what the port validates after training would show here.
* In each package, training moves the view inside the mask: its PSNR up
  by more than 3 dB and the render depth error down below half, while
  the PSNR outside the mask, near perfect on the untrained model's
  empty scene, falls.  The whole view's PSNR, what ``val_img_avg``
  records, sums the two and moves far less.
* The two trainings draw their SDF probe points from different
  generators, so their trained weights differ: they are held to each
  other inside the mask only to 1.5 dB and a depth error within half of
  each other.

``pytest -s`` prints every measurement.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tiny_conf import TINY
from surf_tpu.utils.checkpoint import load_checkpoint as j_load

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.val_after_train import scene_metrics, view_metrics
from surf_tpu_torch.validate import Validator

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

KEYS = ("psnr", "psnr_in_mask", "psnr_out_of_mask", "render_depth_in_mask",
        "sdf_depth_in_mask")


def _jax_runner(tmp_path, text, resume, mode):
    from surf_tpu.runner import Runner
    path = tmp_path / f"jax_{mode}.conf"
    path.write_text(text.replace("./exp/tiny", str(tmp_path / f"jax_{mode}")))
    args = types.SimpleNamespace(mode=mode, conf=str(path), resume=resume,
                                 mesh_resolution=24, clean_mesh=False, scene=None,
                                 ref_view=None, load_vol=False, seed=0)
    runner = Runner(args)
    seen = []
    render = runner.render_full_image

    def recorded(*a, **k):
        seen.append(render(*a, **k))
        return seen[-1]
    runner.render_full_image = recorded

    def metrics():
        runner.validate(0)
        color, _, sdf_depth, render_depth = seen[-1]
        return [view_metrics(runner.val_dataset[0], color, np.asarray(sdf_depth),
                             np.asarray(render_depth))]
    return runner, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("val_after_train")
    text = TINY.replace("train {", "train {\n    dense_render_dtype = float32\n"
                        "    data_parallel = false").replace("perturb = 1.0", "perturb = 0.0")
    assert "data_parallel" in text and "perturb = 0.0" in text
    conf = ConfigFactory.parse_string(text)
    trainer = Trainer(conf, device="cpu", base_exp_dir=str(tmp / "port"), mesh_resolution=24)
    init = trainer.save(-1)
    val = Validator(conf, device="cpu", mesh_resolution=24, base_exp_dir=str(tmp / "port_val"))

    def port_metrics():
        val.params, val.state = trainer.params, trainer.state
        return scene_metrics(val)
    out = {"port": {"untrained": port_metrics()}}
    trainer.train()
    out["port"]["trained"] = port_metrics()

    runner, jax_metrics = _jax_runner(tmp, text, init, "train")
    out["jax"] = {"untrained": jax_metrics()}
    runner.train()
    out["jax"]["trained"] = jax_metrics()
    # the port's trained weights under the JAX runner's validate
    tree = j_load(os.path.join(trainer.base_exp_dir, "checkpoints", "model_001.ckpt.npz"))
    runner.params = jax.tree.map(jnp.asarray, tree["model"])
    runner.state = jax.tree.map(jnp.asarray, tree["state"])
    out["jax_of_port_weights"] = jax_metrics()
    for pkg in ("port", "jax"):
        for when in ("untrained", "trained"):
            print(pkg, when, {k: round(out[pkg][when][0][k], 4) for k in KEYS})
    print("jax validate of the port's trained weights",
          {k: round(out["jax_of_port_weights"][0][k], 4) for k in KEYS})
    return out


def test_jax_validate_of_the_ports_trained_weights_matches(runs):
    got, want = runs["port"]["trained"], runs["jax_of_port_weights"]
    assert [m["scene"] for m in got] == [m["scene"] for m in want]
    for a, b in zip(got, want):
        for k in KEYS + ("mask_share", "sdf_found_share"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_training_moves_the_view_inside_the_mask(runs, pkg):
    for before, after in zip(runs[pkg]["untrained"], runs[pkg]["trained"]):
        assert after["psnr_in_mask"] > before["psnr_in_mask"] + 3.0
        assert after["render_depth_in_mask"] < before["render_depth_in_mask"] / 2
        assert after["psnr_out_of_mask"] < before["psnr_out_of_mask"]
        gain = after["psnr"] - before["psnr"]
        assert abs(gain) < after["psnr_in_mask"] - before["psnr_in_mask"]


def test_port_and_jax_trainings_agree_inside_the_mask(runs):
    for a, b in zip(runs["port"]["trained"], runs["jax"]["trained"]):
        assert abs(a["psnr_in_mask"] - b["psnr_in_mask"]) < 1.5
        ratio = a["render_depth_in_mask"] / b["render_depth_in_mask"]
        assert 2 / 3 < ratio < 3 / 2
