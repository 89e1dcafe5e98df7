"""The port's contracts that hold on any machine:

* a kernel wrapper given CPU tensors takes its plain version and counts
  no launch; given tensors on another device it raises (no fallback);
* no module of surf_tpu_torch, nor chip_smoke.py (whose one import from
  outside the port, ``surfbench.counts``, surfbench's own tests hold to
  the same rule), imports jax or
  anything of surf_tpu, nor ``cv2``, ``PIL``, ``matplotlib``,
  ``skimage``, ``tensorboardX``, ``sklearn``, ``open3d`` or ``trimesh``,
  none of which the card's machine has (checked on the import statements
  with ``ast``: ``surf_tpu_torch`` itself starts with ``surf_tpu``); the
  walk covers every subpackage, the offline evaluation
  (``surf_tpu_torch/evaluation/``), the scalar writer
  (``utils/summary.py``), the training demo (``train_synthetic.py``),
  its summary (``summarize_run.py``) and ``val_after_train.py`` among
  them; nor does any of them
  import the repository's ``tools``, ``tests`` or ``tiny_conf``;
* the entry point refuses to run without a card unless asked for the CPU,
  and its ``--mode`` defaults to the JAX CLI's (main.py), ``train``.

The kernels themselves only run on the card: ``test_kernels_match_plain``
is marked ``cuda`` and skips here (the ``cuda``-marked tests,
tests/*_cuda.py and tests/test_torch_cuda.py, hold every kernel against
its plain version on the card; ``python3 chip_smoke.py`` times each at the
main path's shapes)."""

import ast
import os

import numpy as np
import pytest
import torch

from surf_tpu_torch import _build
from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.geometry.marching_cubes import BlockLattice, lattice_mesh
from surf_tpu_torch.nn import reg_net, sdf_net
from surf_tpu_torch.nn.core import materialize_weight_norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_grid(RNG, device="cpu"):
    parents = torch.tensor([[0, 0, 0], [1, 1, 0], [1, 1, 1]], device=device)
    pvalid = torch.ones(3, dtype=torch.bool, device=device)
    cvalid = torch.from_numpy(RNG.rand(24) < 0.7).to(device)
    grid = sp.make_grid(parents, pvalid, cvalid, 4)
    storage = torch.from_numpy(RNG.randn(24, 3).astype(np.float32)).to(device)
    return grid, storage


def _small_sdf_net(device):
    """A narrow SDF network (hidden 16, a skip, 5 feature channels) with
    random weights, folded, on ``device``."""
    conf = ConfigFactory.parse_string(
        "d_out = 9\nd_in = 3\nd_hidden = 16\nn_layers = 4\nskip_in = [2]\nmultires = 2\n"
        "bias = 0.5\nscale = 1.0\ngeometric_init = false\nweight_norm = true\n"
        "feat_channels = 5\nfeat_multires = 0")
    params, static = sdf_net.init(torch.Generator().manual_seed(3), conf)
    params = materialize_weight_norm(params)
    return {"layers": [{k: v.to(device) for k, v in lin.items()}
                       for lin in params["layers"]]}, static


def _calls(device):
    """Each kernel's wrapper on small inputs (the same for every device)."""
    RNG = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    grid, storage = _small_grid(RNG, device)
    idx = torch.from_numpy(RNG.randint(-1, 10, size=(7, 27)).astype(np.int32)).to(device)
    sdf_p, sdf_s = _small_sdf_net(device)
    # a 10^3 lattice of 4^3 blocks, three of them held (one at its edge)
    blocks = np.zeros((3, 3, 3), bool)
    blocks[0, 0, 0] = blocks[1, 1, 0] = blocks[2, 1, 2] = True
    return {
        "bilinear_sample_2d": lambda: gs.bilinear_sample(
            t(RNG.randn(2, 5, 6, 3)), t(RNG.uniform(-1.2, 1.2, (2, 9, 2)))),
        "trilinear_sample_3d": lambda: gs.trilinear_sample(
            t(RNG.randn(4, 5, 3, 2)), t(RNG.uniform(-1.2, 1.2, (9, 3)))),
        "sparse_trilinear_multi": lambda: sp.sparse_trilinear_multi(
            [(grid, storage)], t(RNG.uniform(-1.1, 1.1, (9, 3))), derivs=True),
        "gather_conv": lambda: reg_net.gather_conv(
            t(RNG.randn(10, 4)), idx, t(RNG.randn(27, 4, 5))),
        "bilinear_sample_2d_bwd": lambda: gs.bilinear_sample_bwd(
            t(RNG.randn(2, 5, 6, 3)), t(RNG.uniform(-1.2, 1.2, (2, 9, 2))),
            t(RNG.randn(2, 9, 3))),
        "trilinear_sample_3d_bwd": lambda: gs.trilinear_sample_bwd(
            t(RNG.randn(4, 5, 3, 2)), t(RNG.uniform(-1.2, 1.2, (9, 3))),
            t(RNG.randn(9, 2))),
        "sparse_trilinear_multi_bwd": lambda: tuple(sp.sparse_trilinear_multi_bwd(
            [(grid, storage)], t(RNG.uniform(-1.1, 1.1, (9, 3))), t(RNG.randn(9, 3)),
            t(RNG.randn(9, 3, 3)), t(RNG.randn(9, 3, 3)), t(RNG.randn(9, 3)))),
        "gather_conv_dw": lambda: reg_net.gather_conv_dw(
            t(RNG.randn(10, 4)), idx, t(RNG.randn(7, 5))),
        "bilinear_sample_2d_bwd2_gather": lambda: gs.bilinear_sample_bwd2_gather(
            t(RNG.randn(2, 5, 6, 3)), t(RNG.uniform(-1.2, 1.2, (2, 9, 2))),
            t(RNG.randn(2, 9, 2)), t(RNG.randn(2, 9, 3))),
        "bilinear_sample_2d_bwd2_scatter": lambda: gs.bilinear_sample_bwd2_scatter(
            t(RNG.randn(2, 5, 6, 3)), t(RNG.uniform(-1.2, 1.2, (2, 9, 2))),
            t(RNG.randn(2, 9, 2)), t(RNG.randn(2, 9, 3))),
        "trilinear_sample_3d_bwd2_gather": lambda: gs.trilinear_sample_bwd2_gather(
            t(RNG.randn(4, 5, 3, 2)), t(RNG.uniform(-1.2, 1.2, (9, 3))),
            t(RNG.randn(9, 3)), t(RNG.randn(9, 2))),
        "trilinear_sample_3d_bwd2_scatter": lambda: gs.trilinear_sample_bwd2_scatter(
            t(RNG.randn(4, 5, 3, 2)), t(RNG.uniform(-1.2, 1.2, (9, 3))),
            t(RNG.randn(9, 3)), t(RNG.randn(9, 2))),
        "sdf_lattice_mlp": lambda: sdf_net.sdf_lattice(
            sdf_p, sdf_s, t(RNG.uniform(-1, 1, (9, 3))), t(RNG.randn(9, 5)),
            torch.from_numpy(RNG.rand(9) < 0.5).to(device)),
        "marching_cubes_lattice": lambda: lattice_mesh(BlockLattice(
            t(RNG.randn(3, 64)), blocks, 10, 4)),
    }


@pytest.mark.parametrize("name", sorted(_build.launches))
def test_cpu_tensors_take_plain_version_without_a_launch(name):
    before = dict(_build.launches)
    out = _calls("cpu")[name]()
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu" and torch.isfinite(first).all()
    assert _build.launches == before


@pytest.mark.parametrize("name", sorted(_build.launches))
def test_other_devices_raise(name):
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        _calls("meta")[name]()


def test_kernels_refuse_tensors_on_two_cards():
    """The device rule also needs one card: a launch runs on the tensors'
    card (``_build.on_device``), so tensors on two cards are refused."""
    from types import SimpleNamespace
    on = [SimpleNamespace(device=torch.device("cuda", i), is_contiguous=lambda: True)
          for i in (0, 1, 1)]
    _build.require_cuda("k", on[1], on[2])
    with pytest.raises(ValueError, match="cards"):
        _build.require_cuda("k", on[0], on[1])


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "surf_tpu", "cv2", "PIL", "matplotlib", "skimage",
                   "tensorboardX", "sklearn", "open3d", "trimesh", "tools", "tests",
                   "tiny_conf")


def test_port_imports_no_jax_and_no_surf_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "surf_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    # the JPEG slice's, the multi-device slice's, the evaluation slice's and
    # the finetune chains' modules are walked too
    assert {os.path.join("surf_tpu_torch", *f.split("/")) for f in (
        "io/jpeg.py", "data/mvs_generic.py", "data/mvs_scene.py", "parallel/__init__.py",
        "parallel/distribute.py", "parallel/mesh.py", "parallel/ray_shard.py",
        "evaluation/__init__.py", "evaluation/clean_mesh.py", "evaluation/dtu_eval.py",
        "evaluation/synthetic.py", "utils/summary.py", "utils/experiment.py",
        "train_synthetic.py", "summarize_run.py", "val_after_train.py",
        "derive_conf.py")} <= {
        os.path.relpath(f, ROOT) for f in files}
    bad = [(os.path.relpath(f, ROOT), n) for f in files for n in _imports(f)
           if _forbidden(n)]
    assert not bad, bad
    # chip_smoke.py takes its yardstick from the benchmark's
    assert "surfbench.counts" in _imports(files[0])
    assert _forbidden("surf_tpu.ops") and not _forbidden("surf_tpu_torch.ops")
    assert all(_forbidden(n) for n in ("cv2", "PIL.Image", "matplotlib.cm",
                                       "skimage.morphology", "tensorboardX",
                                       "tensorboardX.proto.event_pb2",
                                       "sklearn.neighbors", "open3d", "trimesh"))
    assert all(_forbidden(n) for n in ("tools.summarize_run", "tests.tiny_conf", "tiny_conf"))
    assert not _forbidden("zlib") and not _forbidden("scipy.ndimage")


def test_entry_point_needs_a_card_unless_cpu(monkeypatch):
    from surf_tpu_torch import main
    assert main.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main.main(["--conf", os.path.join(ROOT, "confs", "surf_synthetic_full.conf")])


def _jax_cli_default(flag):
    """The default of ``flag`` in the JAX CLI's parser (main.py), read from
    its ``add_argument`` call with ``ast``."""
    tree = ast.parse(open(os.path.join(ROOT, "main.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument" \
                and node.args and getattr(node.args[0], "value", None) == flag:
            kw = {k.arg: k.value for k in node.keywords}
            return ast.literal_eval(kw["default"]), ast.literal_eval(kw["choices"])
    raise AssertionError(f"main.py has no {flag}")


def test_mode_defaults_to_the_jax_clis(monkeypatch):
    """``python -m surf_tpu_torch.main --conf <conf>`` trains, as ``python
    main.py --conf <conf>`` does, and ``--mode`` lists its choices in the
    JAX CLI's order."""
    import argparse
    from surf_tpu_torch import main
    default, choices = _jax_cli_default("--mode")
    assert default == "train"
    parsers, real = [], argparse.ArgumentParser.parse_args

    def kept(self, *a, **kw):
        parsers.append(self)
        return real(self, *a, **kw)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", kept)
    assert main.parse_args([]).mode == default
    assert main.parse_args(["--mode", "val"]).mode == "val"
    mode = next(a for a in parsers[0]._actions if a.dest == "mode")
    assert list(mode.choices) == choices


def test_train_entry_point_needs_a_card_unless_cpu(monkeypatch):
    from surf_tpu_torch import main
    args = main.parse_args(["--mode", "train"])
    assert args.device == "cuda" and not args.clean_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main.main(["--conf", os.path.join(ROOT, "confs", "surf_synthetic_full.conf"),
                   "--mode", "train"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_build.launches))
def test_kernels_match_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    before = _build.launches[name]
    got = _calls("cuda")[name]()
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    ref = _calls("cpu")[name]()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        if r is not None:
            torch.testing.assert_close(g.cpu().float(), r.float(), rtol=1e-5, atol=1e-5)


def test_finetune_entry_point_needs_a_card_unless_cpu(monkeypatch):
    from surf_tpu_torch import main
    args = main.parse_args(["--mode", "finetune", "--resume", "x.npz", "--load_vol"])
    assert args.device == "cuda" and args.load_vol and args.seed == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main.main(["--conf", os.path.join(ROOT, "confs", "surf_synthetic_finetune.conf"),
                   "--mode", "finetune", "--resume", "x.npz"])
