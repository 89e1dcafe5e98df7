"""The mesh lattice's SDF path on the CPU (``sdf_net.sdf_lattice``; the
kernel K5 it launches on the card is held to its plain version by
tests/test_torch_sdf_lattice_cuda.py):

* the plain version equals the composite it replaced in the lattice,
  ``torch.where(occ, apply_occ(...)[0][:, 0], 100)``, bit for bit;
* K5's weight layout (``lattice_layout``: 8-row slices of a canonical
  [h | x_in | features] input, the skip layers' mask, the last layer's
  SDF column) read back by the kernel's arithmetic written
  out in PyTorch matches the plain version, at the published widths and
  at others (feature channels, skips, embedding, scale, feature
  embedding, no weight norm, geometric init);
* the lattice through ``extract_mesh`` equals the old composite over the
  whole lattice, and the lattice function takes the plain version on the
  CPU;
* the layout refuses what the kernel cannot hold."""

import math

import numpy as np
import pytest
import torch

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.nn import sdf_net
from surf_tpu_torch.nn.core import materialize_weight_norm, softplus_beta
from surf_tpu_torch.ops import sparse as sp
from surf_tpu_torch.ops.embedder import embedder
from surf_tpu_torch.validate import LatticeSDF, extract_mesh

torch.set_num_threads(1)

# the published SDF network (confs/surf.conf) with random, not geometric,
# weights: geometric init zeroes the feature columns, which would hide the
# feature path
PUBLISHED = dict(d_out=129, d_in=3, d_hidden=128, n_layers=6, skip_in=[3], multires=4,
                 bias=0.5, scale=1.0, geometric_init="false", weight_norm="true",
                 feat_channels=28, feat_multires=0)

CASES = {
    "published": {},
    "synthetic_14_channels": dict(feat_channels=14),
    "mid_21_channels": dict(feat_channels=21),
    "two_skips_scale_multires_6": dict(skip_in=[2, 4], scale=0.5, multires=6),
    "narrow_no_embedding": dict(d_hidden=64, n_layers=4, skip_in=[2], multires=0,
                                feat_channels=7, d_out=9),
    "feature_embedding": dict(feat_channels=7, feat_multires=1),
    "no_weight_norm": dict(weight_norm="false"),
    "geometric_init": dict(geometric_init="true"),
}


def model(seed=0, **over):
    kw = dict(PUBLISHED, **over)
    conf = ConfigFactory.parse_string("\n".join(f"{k} = {v}" for k, v in kw.items()))
    params, static = sdf_net.init(torch.Generator().manual_seed(seed), conf)
    return materialize_weight_norm(params), static


def stages_for(channels, seed=0, octant=False):
    """Two random sparse stages (8^3 and 16^3) of ``channels`` split in two;
    with ``octant`` in the low octant of the box only."""
    rng = np.random.RandomState(seed)
    out = []
    for res, c in ((8, channels // 2), (16, channels - channels // 2)):
        half = res // 2
        coords = np.stack(np.meshgrid(*[np.arange(half)] * 3, indexing="ij"), -1).reshape(-1, 3)
        if octant:
            coords = coords[(coords < half // 2).all(-1)]
        keep = coords[rng.rand(len(coords)) < 0.3]
        parents = torch.from_numpy(keep)
        grid = sp.make_grid(parents, torch.ones(len(keep), dtype=torch.bool),
                            torch.from_numpy(rng.rand(len(keep) * 8) < 0.7), res)
        out.append((grid, torch.from_numpy(rng.randn(len(keep) * 8, c).astype(np.float32))))
    return out


def points(n, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32))


def kernel_arithmetic(layout, static, pts, feats, occ):
    """K5's arithmetic written out on ``layout``: the canonical input rows,
    each hidden layer's slices summed into 128 outputs, bias and Softplus
    over the h rows (times 1/sqrt(2) where the next layer is a skip layer,
    and x_in's rows too once layer 0 has read them), the last layer's
    column over every row."""
    n, inv = pts.shape[0], 1.0 / math.sqrt(2)
    act = torch.zeros((n, layout["rows"]))
    e = slice(layout["e_row"], layout["e_row"] + layout["E"])
    embed, _ = embedder(static["multires"], 3)
    act[:, e] = embed(pts * static["scale"])
    act[:, layout["f_row"]:layout["f_row"] + layout["F"]] = feats
    start = 0
    for l, end in enumerate(layout["layer_end"]):
        acc = torch.zeros((n, sdf_net.K5_WIDTH))
        for s in range(start, end):
            r = layout["slice_row"][s]
            acc = acc + act[:, r:r + sdf_net.K5_SLICE] @ layout["w"][s]
        start = end
        if l == 0 and layout["skip"]:
            act[:, e] = act[:, e] * inv
        h = softplus_beta(acc + layout["bias"][l])
        act[:, :sdf_net.K5_WIDTH] = h * inv if (layout["skip"] >> (l + 1)) & 1 else h
    sdf = (act @ layout["w_last"] + layout["b_last"]) / static["scale"]
    return torch.where(occ, sdf, torch.full_like(sdf, 100.0))


@torch.no_grad()
def test_plain_equals_the_old_composite_bit_for_bit():
    p, static = model()
    stages = stages_for(28)
    pts = points(5000)
    out, occ = sdf_net.apply_occ(p, static, pts, stages)
    old = torch.where(occ, out[:, 0], torch.full_like(out[:, 0], 100.0))
    feats, occ2 = sp.stage_features(stages, pts)
    new = sdf_net.sdf_lattice(p, static, pts, feats, occ2)
    assert 0 < int(occ.sum()) < len(occ)
    assert torch.equal(new, old)


@torch.no_grad()
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_read_as_the_kernel_reads_it_matches_plain(case):
    p, static = model(1, **CASES[case])
    rng = np.random.RandomState(2)
    pts = points(3000, 3)
    feats = torch.from_numpy(rng.randn(3000, static["feat_channels"]).astype(np.float32))
    occ = torch.from_numpy(rng.rand(3000) < 0.6)
    ref = sdf_net.sdf_lattice_plain(p, static, pts, feats, occ)
    layout = sdf_net.lattice_layout(p, static)
    if static["feat_multires"] > 0:
        feats = embedder(static["feat_multires"], static["feat_channels"])[0](feats)
    got = kernel_arithmetic(layout, static, pts, feats, occ)
    assert layout["rows"] % sdf_net.K5_SLICE == 0
    assert layout["w"].shape == (layout["layer_end"][-1], sdf_net.K5_SLICE, sdf_net.K5_WIDTH)
    assert (ref[~occ] == 100.0).all() and (ref[occ] != 100.0).all()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_published_layout_slices():
    """At the published widths: 184 canonical rows; layer 0 reads x_in's
    four slices, the skip layer h's first 101 rows, x_in and the
    features, the others h and the features: 104 slices of 8 x 128."""
    p, static = model()
    layout = sdf_net.lattice_layout(p, static)
    assert (layout["rows"], layout["e_row"], layout["f_row"]) == (184, 128, 155)
    per_layer = np.diff([0] + layout["layer_end"]).tolist()
    assert per_layer == [4, 20, 20, 20, 20, 20]
    assert layout["slice_row"][:4] == [128, 136, 144, 152]
    skip = layout["slice_row"][44:64]
    assert skip == list(range(0, 104, 8)) + list(range(128, 184, 8))
    # the skip layer's weights as they are (the kernel scales its input)
    assert layout["skip"] == 1 << 3
    assert torch.equal(layout["w"][44][:, :128], p["layers"][3]["w"][:8])
    assert layout["w_last"].shape == (184,) and layout["b_last"] == float(p["layers"][6]["b"][0])


@torch.no_grad()
def test_lattice_through_extract_mesh_equals_the_old_composite():
    p, static = model(4)
    stages = stages_for(28, 5, octant=True)
    isf, isf_static = {"sdf_network": p}, {"sdf": static}
    R = 24
    stats = {}
    _, _, u = extract_mesh(isf, isf_static, stages, R, block=8, stats=stats)
    # the lattice's coordinates as extract_geometry forms them
    lin = -1.0 + (2.0 / (R - 1.0)) * torch.arange(R).float()
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out, occ = sdf_net.apply_occ(p, static, grid, stages)
    old = torch.where(occ, out[:, 0], torch.full_like(out[:, 0], 100.0)).reshape(R, R, R)
    np.testing.assert_allclose(u, old.numpy(), rtol=1e-6, atol=1e-6)
    occupied, total = stats["lattice_blocks"]
    assert 0 < occupied < total and stats["lattice_points"] == occupied * 8 ** 3


@torch.no_grad()
def test_lattice_fn_takes_the_plain_version_on_the_cpu():
    p, static = model()
    stages = stages_for(28)
    fn = LatticeSDF({"sdf_network": p}, {"sdf": static}, stages)
    pts = points(700)
    feats, occ = sp.stage_features(stages, pts)
    assert torch.equal(fn(pts), sdf_net.sdf_lattice_plain(p, static, pts, feats, occ))


@pytest.mark.parametrize("over", [dict(d_hidden=256), dict(skip_in=[0]),
                                  dict(multires=12, feat_channels=300)])
def test_layout_refuses_what_the_kernel_cannot_hold(over):
    p, static = model(**over)
    with pytest.raises(ValueError, match="sdf_lattice"):
        sdf_net.lattice_layout(p, static)


@torch.no_grad()
def test_lattice_function_keeps_no_reference_cycle():
    """The lattice function holds the stages; nothing of it may outlive the
    mesh in a reference cycle (the stages would stay on the card until the
    garbage collector ran, a validate's worth more memory at the next
    one's peak)."""
    import gc
    import weakref
    p, static = model()
    stages = stages_for(28, 5, octant=True)
    kept = weakref.ref(stages[1][1])
    gc.disable()
    try:
        stats = {}
        extract_mesh({"sdf_network": p}, {"sdf": static}, stages, 16, block=8, stats=stats)
        del stages
        assert kept() is None
    finally:
        gc.enable()
