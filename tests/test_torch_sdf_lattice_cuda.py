"""K5 (``sdf_net.sdf_lattice`` on the card, csrc/sdf_lattice_mlp.cu)
against its plain version on the card (tests marked ``cuda``; they skip
without an NVIDIA GPU and import no JAX: ``python -m pytest
tests/test_torch_sdf_lattice_cuda.py -m cuda --noconftest``):

* at the mesh lattice's call (2,097,152 points), a ragged last tile
  (1,000,003) and one point, at the published widths with random weights
  (geometric init zeroes the feature columns and would hide the feature
  path) and a mix of occupied and empty points: max abs gap <= 1e-5, the
  empty points exactly 100, one launch a call;
* at other widths (14 and 21 feature channels, two skips with scale 0.5
  and 6 frequencies, a narrow net without embedding, 32 hidden units with
  3 frequencies and 9 feature channels, embedded features);
* a non-contiguous input, tensors on the CPU and the card together and
  a wrong dtype raise, and launch nothing."""

import pytest
import torch

from surf_tpu_torch import _build
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.nn import sdf_net
from surf_tpu_torch.nn.core import materialize_weight_norm

PUBLISHED = dict(d_out=129, d_in=3, d_hidden=128, n_layers=6, skip_in=[3], multires=4,
                 bias=0.5, scale=1.0, geometric_init="false", weight_norm="true",
                 feat_channels=28, feat_multires=0)

WIDTHS = {
    "synthetic_14_channels": dict(feat_channels=14),
    "mid_21_channels": dict(feat_channels=21),
    "two_skips_scale_multires_6": dict(skip_in=[2, 4], scale=0.5, multires=6),
    "narrow_no_embedding": dict(d_hidden=64, n_layers=4, skip_in=[2], multires=0,
                                feat_channels=7, d_out=9),
    "hidden_32_multires_3": dict(d_hidden=32, n_layers=4, skip_in=[2], multires=3,
                                 feat_channels=9, d_out=5),
    "feature_embedding": dict(feat_channels=7, feat_multires=1),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch.card import set_numerics
    set_numerics()
    return torch.device("cuda")


def model(dev, seed=0, **over):
    kw = dict(PUBLISHED, **over)
    conf = ConfigFactory.parse_string("\n".join(f"{k} = {v}" for k, v in kw.items()))
    params, static = sdf_net.init(torch.Generator().manual_seed(seed), conf)
    params = materialize_weight_norm(params)
    return {"layers": [{k: v.to(dev) for k, v in lin.items()}
                       for lin in params["layers"]]}, static


def inputs(dev, n, channels, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((n, 3), generator=g, device=dev) * 2.2 - 1.1
    feats = torch.randn((n, channels), generator=g, device=dev)
    occ = torch.rand((n,), generator=g, device=dev) < 0.6
    return pts, feats, occ


def check(p, static, pts, feats, occ):
    before = _build.launches["sdf_lattice_mlp"]
    got = sdf_net.sdf_lattice(p, static, pts, feats, occ)
    torch.cuda.synchronize()
    assert _build.launches["sdf_lattice_mlp"] == before + 1
    ref = sdf_net.sdf_lattice_plain(p, static, pts, feats, occ)
    assert torch.isfinite(got).all()
    assert (got[~occ] == 100.0).all()
    gap = (got - ref).abs().max().item()
    assert gap <= 1e-5, gap
    return gap


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2_097_152, 1_000_003, 1])
def test_k5_matches_plain_at_the_lattice_call(card, n):
    p, static = model(card)
    pts, feats, occ = inputs(card, n, 28, seed=n)
    if n == 1:
        occ[:] = True
    check(p, static, pts, feats, occ)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_k5_matches_plain_at_other_widths(card, case):
    p, static = model(card, 1, **WIDTHS[case])
    check(p, static, *inputs(card, 70_001, static["feat_channels"], seed=7))


@pytest.mark.cuda
def test_k5_refuses_what_it_cannot_take(card):
    p, static = model(card)
    pts, feats, occ = inputs(card, 1000, 28)
    before = _build.launches["sdf_lattice_mlp"]
    wide = torch.zeros((1000, 6), device=card)
    with pytest.raises(ValueError, match="non-contiguous"):
        sdf_net.sdf_lattice(p, static, wide[:, :3], feats, occ)
    with pytest.raises(ValueError, match="non-contiguous"):
        sdf_net.sdf_lattice(p, static, pts, feats.t().contiguous().t(), occ)
    with pytest.raises(ValueError):
        sdf_net.sdf_lattice(p, static, pts, feats.cpu(), occ)
    with pytest.raises(ValueError):
        sdf_net.sdf_lattice(p, static, pts, feats, occ.cpu())
    with pytest.raises(ValueError, match="f32"):
        sdf_net.sdf_lattice(p, static, pts, feats.double(), occ)
    with pytest.raises(ValueError, match="feature channels"):
        sdf_net.sdf_lattice(p, static, pts, feats[:, :20].contiguous(), occ)
    assert _build.launches["sdf_lattice_mlp"] == before
