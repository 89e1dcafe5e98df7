"""Port parity of the reference-checkpoint converter: a synthetic reference
state_dict (the key space of surf_tpu/convert/torch_converter.py:3-14,
made from a numpy seed in the shapes of the port's ``surf.init`` tree by
the inverse of each layout mapping) goes through
``surf_tpu.convert.torch_converter.convert_checkpoint`` and
``surf_tpu_torch.convert.convert_checkpoint``: the two trees are equal
bit for bit, and their keys and shapes are the port's init tree's, for 2
and 4 stages.  The CLI's npz resumes through ``utils.resume_from``."""

import os

import numpy as np
import pytest
import torch

from tiny_conf import TINY
from surf_tpu.convert import torch_converter as jconv

from surf_tpu_torch import convert as tconv
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.nn import surf
from surf_tpu_torch.utils import load_checkpoint, resume_from, to_torch_tree

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

FULL_CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "confs", "surf_synthetic_full.conf")


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [(path, tree)]


def _state_dict(params, state, rng):
    """A reference state_dict whose conversion has the shapes of the init
    tree (params, state): Linear (out, in), Conv2d (out, in, kh, kw),
    ConvTranspose2d (in, out, kh, kw), torchsparse (27, in, out),
    weight-norm v (out, in) / g (out, 1)."""
    sd = {}

    def put(key, shape):
        sd[key] = np.asarray(rng.randn(*shape), np.float32)

    def lin(prefix, p):
        put(f"{prefix}.weight", p["w"].shape[::-1])
        if "b" in p:
            put(f"{prefix}.bias", p["b"].shape)

    def conv2d(prefix, p, transposed=False):
        kh, kw, ci, co = p["w"].shape
        put(f"{prefix}.weight", (ci, co, kh, kw) if transposed else (co, ci, kh, kw))

    for prefix, fp in (("feature_network", params["feature_network"]),
                       ("match_feature_network", state["match_feature_network"])):
        for i, enc in enumerate(fp["encoder"]):
            conv2d(f"{prefix}.encoder_layers.{i}.0.conv", enc["c0"])
            conv2d(f"{prefix}.encoder_layers.{i}.1.conv", enc["c1"])
        for i, o in enumerate(fp["out"]):
            conv2d(f"{prefix}.out_layers.{i}", o)
        for i, d in enumerate(fp["decoder"]):
            conv2d(f"{prefix}.decoder_layers.{i}.conv", d, transposed=True)
    for i, p in zip((0, 2), params["volume"]["agg_mlp"]):
        lin(f"volume.agg_mlp.{i}", p)
    for s, rp in enumerate(params["reg_network"]):
        for name in tconv.REG_CONVS:
            base = f"reg_network.nets.{s}.{name}.net"
            k, _, _, ci, co = rp[name]["conv"]["w"].shape
            put(f"{base}.0.kernel", (k ** 3, ci, co))
            for leaf in ("weight", "bias", "running_mean"):
                put(f"{base}.1.{leaf}", (co,))
            sd[f"{base}.1.running_var"] = rng.uniform(0.5, 2.0, co).astype(np.float32)
        put(f"reg_network.nets.{s}.out_lin.weight", rp["out_lin"]["w"].shape[::-1])
    isf = params["implicit_surface"]
    for i, p in enumerate(isf["sdf_network"]["layers"]):
        prefix = f"implicit_surface.sdf_network.lin{i}"
        put(f"{prefix}.weight_v", p["v"].shape[::-1])
        put(f"{prefix}.weight_g", (p["g"].shape[0], 1))
        put(f"{prefix}.bias", p["b"].shape)
    cn = isf["color_network"]
    for name, seq in cn.items():
        if name == "s":
            put("implicit_surface.color_network.s", seq.shape)
            continue
        for i, p in zip((0, 2, 4), seq):
            lin(f"implicit_surface.color_network.{name}.{i}", p)
    put("implicit_surface.deviation_network.variance",
        isf["deviation_network"]["variance"].shape)
    # a DDP-saved checkpoint: every key under 'module.'
    return {f"module.{k}": v for k, v in sd.items()}


def _init(num_stage):
    if num_stage == 2:
        conf = ConfigFactory.parse_string(TINY)
    else:
        conf = ConfigFactory.parse_file(FULL_CONF)
    assert len(conf.get_list("model.range_ratios")) == num_stage
    return surf.init(conf["model"], device="cpu")[:2]


@pytest.mark.parametrize("num_stage", [2, 4])
def test_converter_matches_jax_and_the_init_tree(num_stage):
    params, state = _init(num_stage)
    sd = _state_dict(params, state, np.random.RandomState(num_stage))
    n_layers = len(params["implicit_surface"]["sdf_network"]["layers"])
    got = tconv.convert_checkpoint(sd, num_stage=num_stage, sdf_layers=n_layers)
    ref = jconv.convert_checkpoint(sd, num_stage=num_stage, sdf_layers=n_layers)
    for g, r, init in zip(got, ref, (params, state)):
        pg, pr, pi = _paths(g), _paths(r), _paths(init)
        assert [p for p, _ in pg] == [p for p, _ in pr]
        for (p, a), (_, b) in zip(pg, pr):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg=str(p))
        assert sorted(p for p, _ in pg) == sorted(p for p, _ in pi)
        shapes = {p: tuple(t.shape) for p, t in pi}
        for p, a in pg:
            assert a.shape == shapes[p], p
    # every entry of the state_dict was used
    used = sum(a.size for _, a in _paths(got))
    assert used == sum(v.size for v in sd.values())


def test_converter_cli_writes_a_checkpoint_that_resumes(tmp_path):
    params, state = _init(2)
    sd = _state_dict(params, state, np.random.RandomState(5))
    src, dst = tmp_path / "ref.ckpt", tmp_path / "converted.npz"
    torch.save({"epoch": 15, "model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(src))
    tconv.main(["--src", str(src), "--dst", str(dst), "--num_stage", "2"])
    assert int(load_checkpoint(str(dst))["epoch"]) == -1
    want_p, want_s = tconv.convert_checkpoint(sd, num_stage=2)
    got_p, got_s, vol = resume_from(str(dst), params, state)
    assert vol is None
    for got, want in ((got_p, to_torch_tree(want_p)), (got_s, to_torch_tree(want_s))):
        pg, pw = _paths(got), _paths(want)
        assert [p for p, _ in pg] == [p for p, _ in pw]
        for (p, a), (_, b) in zip(pg, pw):
            assert torch.equal(a, b), p
