"""The port's backward kernels and training step on the card (tests
marked ``cuda``; they skip without an NVIDIA GPU, and import no JAX, so
they run on the card's machine: ``python -m pytest tests/test_torch_cuda.py
-m cuda``).

* K1b, K2b, K3b and K4w against their plain versions on odd shapes with
  points outside the image / volume / grid;
* K2b at C = 1, 3, 4, 5, 16 in f32 and bf16 (and at C = 3 with both
  ``align_corners``), both forms of a bf16 volume's
  gradient, with and without d_coords, on a band of samples in a few
  bricks, a whole-volume scatter, a one-voxel pile-up and all-zero
  cotangents; K3b for every subset of its cotangents at 1-4 stages, with
  absent rows, clamped corners and ragged N;
* K1 and K1b against their plain versions at every channel count their
  kernels specialise and two they do not, one and five views, one point
  and a count that is no multiple of the block, normalized and pixel
  coordinates, points outside the image, all-zero cotangent rows, a
  pile-up on one texel, each (d_image, d_coords) combination, and
  images and coordinates off their vector alignment;
* K2 and K3 against their plain versions, equal bit for bit: K2 at C = 1,
  3, 5 in f32 and bf16 (even and odd z sizes, a volume off its
  allocation's alignment, points outside, N no multiple of the block);
  K3 at 1-4 stages, C = 7 and 1, 5, 8, value only, derivatives and the
  training variant, points on cell faces, on the border and outside,
  absent parents and children, occupancy equal;
* K4 and K4w against their plain versions at every (Cin, Cout) of the
  path, with and without the live-row mask (a mask that also drops rows
  holding taps: those read nothing); ragged shapes (T < 27, Cin 1, 5, 13
  and 32, R no multiple of the row group, Cin % 4 == 0 off its 16-byte
  alignment); an all -1 table, one input row read by every row and tap,
  every tap present on every row; K4 twice, equal bit for bit;
* K1g / K1s and K2g / K2s (the second order of K1 and K2) against their
  plain versions: the gathers' directional term bit for bit, their
  Hessian term bit for bit at one channel, the scatters at 1e-5 (bf16: one
  step), at K1's and K2's channel counts, off alignment, each gather term
  alone; the double backward of ``bilinear_sample_2d`` /
  ``trilinear_sample_3d`` on the card against the CPU;
* ``loss.backward()`` of the tiny model on the card against the same step
  on the CPU (whose plain versions tests/test_torch_train.py holds against
  the JAX package);
* the tiny model's ``--clean_mesh`` validate on the card against the CPU
  on a DTU-layout scene and on the BlendedMVS, Tanks and ETH3D layouts
  (JPEG images, 3, 5 and 7 views)."""

import contextlib

import numpy as np
import pytest
import torch

from tiny_conf import TINY
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.ops import grid_sample as tgs, sparse as tsp
from surf_tpu_torch.nn import reg_net as trn
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import checkpoint as tckpt
from surf_tpu_torch.validate import to_device

RTOL = 1e-5


def _close(got, ref, rtol=RTOL, atol=1e-5):
    """atol relative to max(1, the largest reference entry)."""
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [(path, tree)]


def _ragged_stages(g, dev):
    stages = []
    for res, keep, C in ((32, 0.3, 7), (16, 0.5, 5), (8, 0.7, 3), (4, 0.9, 2)):
        half = res // 2
        r = torch.arange(half)
        allp = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        parents = allp[torch.rand(len(allp), generator=g) < keep]
        cvalid = torch.rand(len(parents) * 8, generator=g) < 0.8
        grid = tsp.make_grid(parents.to(dev), torch.ones(len(parents), dtype=torch.bool,
                                                           device=dev), cvalid.to(dev), res)
        stages.append((grid, torch.randn(len(parents) * 8, C, generator=g).to(dev)))
    return stages


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1b", "K2b", "K3b", "K4w"])
def test_backward_kernel_matches_plain_on_ragged_shapes(kernel):
    """Each backward kernel against its plain version on the card, on odd
    shapes with points outside the image / volume / grid (K1b and K2b with
    both ``align_corners``).  The kernels sum
    with atomics in a run-dependent order: rtol 1e-5, atol 1e-5 times
    max(1, the largest entry), one bf16 step for a bf16 volume's gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(9)
    dev = torch.device("cuda")
    cases = []
    if kernel == "K1b":
        for align in (True, False):
            img = torch.randn(3, 37, 53, 5, generator=g).to(dev)
            co = (torch.rand(3, 1001, 2, generator=g) * 2.6 - 1.3).to(dev)
            ct = torch.randn(3, 1001, 5, generator=g).to(dev)
            kw = dict(align_corners=align)
            cases.append((tgs.bilinear_sample_bwd(img, co, ct, **kw),
                          tgs.bilinear_sample_bwd_plain(img, co, ct, **kw)))
        name = "bilinear_sample_2d_bwd"
    elif kernel == "K2b":
        for dt in (torch.float32, torch.bfloat16):
            vol = torch.randn(13, 9, 11, 3, generator=g).to(dev, dt)
            pts = (torch.rand(2003, 3, generator=g) * 2.5 - 1.25).to(dev)
            ct = torch.randn(2003, 3, generator=g).to(dev)
            for align in (False, True):
                kw = dict(align_corners=align)
                cases.append((tgs.trilinear_sample_bwd(vol, pts, ct, **kw),
                              tgs.trilinear_sample_bwd_plain(vol, pts, ct, **kw)))
        name = "trilinear_sample_3d_bwd"
    elif kernel == "K3b":
        stages = _ragged_stages(g, dev)
        n, C = 3001, sum(s.shape[1] for _, s in stages)
        pts = (torch.rand(n, 3, generator=g) * 2.3 - 1.15).to(dev)
        cts = [torch.randn(*sh, generator=g).to(dev)
               for sh in ((n, C), (n, 3, C), (n, 3, C), (n, C))]
        got = tsp.sparse_trilinear_multi_bwd(stages, pts, *cts)
        assert len(got) == len(stages)
        cases.append((got, tsp.sparse_trilinear_multi_bwd_plain(stages, pts, *cts)))
        name = "sparse_trilinear_multi_bwd"
    else:
        x = torch.randn(1003, 13, generator=g).to(dev)
        idx = torch.randint(-1, 1003, (2011, 27), generator=g).to(dev, torch.int32)
        ct = torch.randn(2011, 7, generator=g).to(dev)
        cases.append(((trn.gather_conv_dw(x, idx, ct),), (trn.gather_conv_dw_plain(x, idx, ct),)))
        name = "gather_conv_dw"
    torch.cuda.synchronize()
    assert _build.launches[name] >= len(cases)
    for got, ref in cases:
        for a, b in zip(got, ref):
            if b is not None:
                # a bf16 volume's gradient is summed in f32 and rounded once:
                # the two may round to neighbouring bf16 values
                rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else RTOL
                _close(a.float().cpu().numpy(), b.float().cpu().numpy(), rtol=rtol,
                       atol=1e-5)


def _k1_cases(g, V, N, H, W):
    """(name, coords, kwargs) of K1 / K1b calls: normalized coordinates
    (both conventions) and pixel coordinates reaching outside the image,
    and a pile-up of every point inside one texel cell."""
    norm = torch.rand(V, N, 2, generator=g) * 2.6 - 1.3
    pix = torch.rand(V, N, 2, generator=g) * torch.tensor([W + 4.0, H + 4.0]) - 2.0
    pile = torch.tensor([0.137, -0.261]) + torch.rand(V, N, 2, generator=g) * 0.005
    return [("normalized, align_corners", norm, dict(align_corners=True)),
            ("normalized", norm, dict(align_corners=False)),
            ("pixel", pix, dict(normalized=False)),
            ("pile-up", pile, dict(align_corners=True))]


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 5])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 19, 32])
def test_k1_k1b_match_plain(C, V):
    """K1 (deterministic, no atomics: rtol/atol 1e-5) and K1b (atomics:
    rtol 1e-5, atol 1e-5 times max(1, the largest entry)) against their
    plain versions on the card.  The cotangent is zero on one row in
    three and on the whole first view (rows K1b does not scatter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(100 * C + V)
    dev = torch.device("cuda")
    H, W = 23, 31
    img = torch.randn(V, H, W, C, generator=g).to(dev)
    _build.reset_launches()
    n_calls = n_bwd = 0
    for N in (1, 1000):
        for what, co, kw in _k1_cases(g, V, N, H, W):
            co = co.to(dev)
            _close(tgs.bilinear_sample(img, co, **kw).cpu().numpy(),
                   tgs.bilinear_sample_plain(img, co, **kw).cpu().numpy())
            n_calls += 1
            ct = torch.randn(V, N, C, generator=g)
            ct[:, ::3] = 0.0
            ct[0] = 0.0
            ct = ct.to(dev)
            for need in ((True, True), (True, False), (False, True)):
                flags = dict(kw, need_images=need[0], need_coords=need[1])
                got = tgs.bilinear_sample_bwd(img, co, ct, **flags)
                ref = tgs.bilinear_sample_bwd_plain(img, co, ct, **flags)
                n_bwd += 1
                for a, b, on in zip(got, ref, need):
                    assert (a is None) == (not on), (what, need)
                    if on:
                        _close(a.cpu().numpy(), b.cpu().numpy())
    torch.cuda.synchronize()
    assert _build.launches["bilinear_sample_2d"] == n_calls
    assert _build.launches["bilinear_sample_2d_bwd"] == n_bwd


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 4, 32])
def test_k1_k1b_off_alignment(C):
    """An image that starts 4 bytes past a 16-byte boundary (the kernels
    drop their 16-byte vectors) and coordinates 4 bytes past an 8-byte
    one (the wrapper copies them) give the plain versions' values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(C)
    dev = torch.device("cuda")
    V, H, W, N = 2, 17, 19, 555
    img = torch.randn(V * H * W * C + 1, generator=g).to(dev)[1:].view(V, H, W, C)
    co = (torch.rand(V * N * 2 + 1, generator=g) * 2.4 - 1.2).to(dev)[1:].view(V, N, 2)
    ct = torch.randn(V, N, C, generator=g).to(dev)
    assert img.data_ptr() % 16 and co.data_ptr() % 8
    _close(tgs.bilinear_sample(img, co).cpu().numpy(),
           tgs.bilinear_sample_plain(img, co).cpu().numpy())
    for a, b in zip(tgs.bilinear_sample_bwd(img, co, ct),
                    tgs.bilinear_sample_bwd_plain(img, co, ct)):
        _close(a.cpu().numpy(), b.cpu().numpy())


def _k2_points(g, n):
    """n points over and beyond the volume, then points on its corners and
    faces, then a run along z in steps of a quarter voxel (at Z = 8), so
    that odd and even z0 sit side by side."""
    pts = torch.rand(n, 3, generator=g) * 2.6 - 1.3
    pts[:6] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [1.0, -1.0, 0.0],
                            [0.0, 1.0, -1.0], [1.2, 0.3, -1.4], [-1.05, 0.5, 1.05]])
    run = torch.linspace(-1.2, 1.2, 64)
    pts[6:70] = torch.stack([torch.full_like(run, 0.1), torch.full_like(run, -0.3), run], -1)
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_k2_matches_plain_bit_for_bit(C, dtype):
    """K2 against its plain version, equal bit for bit: an even and an odd
    voxel count, a volume one element past its allocation's alignment, both
    ``align_corners``, pixel coordinates, one point and 1001 (no multiple
    of the block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(50 + C)
    dev = torch.device("cuda")
    _build.reset_launches()
    n_calls = 0
    for shape in ((12, 10, 8), (13, 9, 11)):
        numel = shape[0] * shape[1] * shape[2] * C
        vols = [torch.randn(*shape, C, generator=g).to(dev, dt),
                torch.randn(numel + 1, generator=g).to(dev, dt)[1:].view(*shape, C)]
        for vol in vols:
            for n in (1, 1001):
                pts = _k2_points(g, max(n, 70))[:n].to(dev)
                for kw in (dict(align_corners=True), dict(align_corners=False),
                           dict(normalized=False)):
                    co = (pts + 1.3) * 5.0 if "normalized" in kw else pts
                    got = tgs.trilinear_sample(vol, co, **kw)
                    assert torch.equal(got, tgs.trilinear_sample_plain(vol, co, **kw)), \
                        (shape, n, kw)
                    n_calls += 1
    torch.cuda.synchronize()
    assert _build.launches["trilinear_sample_3d"] == n_calls


def _k2b_cases(g):
    """(name, coords, cotangent mask) of K2b calls on a volume of
    ``shape``: a band of ray-ordered samples in a few bricks, samples
    spread over the whole volume and past its faces, a pile-up of every
    sample in one voxel's cell, and the band again with an all-zero
    cotangent; N no multiple of the block."""
    t = torch.linspace(0.0, 1.0, 48)
    o = torch.rand(23, 1, 3, generator=g) * 0.3 - 0.8
    band = (o + t[None, :, None] * torch.tensor([0.15, 0.05, 0.3])).reshape(-1, 3)
    spread = torch.rand(3001, 3, generator=g) * 2.4 - 1.2
    pile = torch.tensor([0.11, -0.23, 0.37]) + torch.rand(777, 3, generator=g) * 1e-3
    return [("band", band, 1.0), ("whole volume", spread, 1.0), ("pile-up", pile, 1.0),
            ("zero cotangent", band, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 16])
def test_k2b_forms_match_plain(C, dtype):
    """K2b against its plain version on the card (atomics: rtol 1e-5, atol
    1e-5 times max(1, the largest entry); one bf16 step for a bf16
    volume's gradient, summed in f32 and rounded once), both forms of a
    bf16 volume's gradient (single pass and bricked), with and without
    d_coords, on ``_k2b_cases``; one volume whose sides are multiples of 8
    and one whose are not; rows of the cotangent zero one in five; at C
    other than 1 the rows form (merged rows; 16-byte atomics at C = 4 and
    16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(60 + C)
    dev = torch.device("cuda")
    _build.reset_launches()
    n_calls = 0
    forms = (False, True) if dt == torch.bfloat16 else (False,)
    for shape in ((16, 24, 32), (13, 9, 11)):
        vol = torch.randn(*shape, C, generator=g).to(dev, dt)
        for what, co, on in _k2b_cases(g):
            co = co.to(dev)
            ct = torch.randn(co.shape[0], C, generator=g) * on
            ct[::5] = 0.0
            ct = ct.to(dev)
            for need in ((True, False), (True, True), (False, True)):
                kw = dict(align_corners=False, need_volume=need[0], need_coords=need[1])
                ref = tgs.trilinear_sample_bwd_plain(vol, co, ct, **kw)
                for bricked in forms:
                    got = tgs.trilinear_sample_bwd(vol, co, ct, bricked=bricked, **kw)
                    n_calls += 1
                    for a, b, want in zip(got, ref, need):
                        assert (a is None) == (not want), (what, need)
                        if want:
                            assert a.dtype == b.dtype
                            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else RTOL
                            _close(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   rtol=rtol)
    torch.cuda.synchronize()
    assert _build.launches["trilinear_sample_3d_bwd"] == n_calls


def _second_order_check(got, ref, exact_dir, exact_hess, rtol=RTOL):
    """(directional, Hessian) of K1g / K2g against their plain versions:
    the directional term equal bit for bit (the plain version's operation
    order), the Hessian term too where ``exact_hess`` (one channel: no
    channel sum), else rtol 1e-5 (the plain version's channel sum is
    PyTorch's)."""
    for a, b, exact in zip(got, ref, (exact_dir, exact_hess)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if exact:
            assert torch.equal(a, b)
        else:
            _close(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol)


def _k1_shared_cases(g, V, N, H, W):
    """(name, coords, kwargs) where the lanes of a warp share texels: runs
    of 40 consecutive points in one texel cell each, and ray-ordered points
    stepping 0.05 texels a point along 8 rays a view (some 20 consecutive
    points a cell, the cells changing slowly), normalized with
    ``align_corners``."""
    cells = torch.stack([torch.randint(0, W - 1, (V, -(-N // 40)), generator=g),
                         torch.randint(0, H - 1, (V, -(-N // 40)), generator=g)], -1)
    runs = cells.repeat_interleave(40, 1)[:, :N] + torch.rand(V, N, 2, generator=g)
    per = -(-N // 8)
    start = torch.rand(V, 8, 1, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0])
    ang = torch.rand(V, 8, 1, 1, generator=g) * 6.2832
    step = 0.05 * torch.cat([torch.cos(ang), torch.sin(ang)], -1)
    rays = (start + step * torch.arange(per)[:, None]).reshape(V, 8 * per, 2)[:, :N]
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)])
    return [("runs of 40 points a cell", runs * scale - 1.0, dict(align_corners=True)),
            ("ray-ordered points", rays * scale - 1.0, dict(align_corners=True))]


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 5])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 16, 19, 32])
def test_k1g_k1s_match_plain(C, V):
    """K1g and K1s (the second order of K1) against their plain versions on
    the card at every channel count K1's kernels specialise, two they do
    not and the triplane's 16: K1g's directional term bit for bit, its
    Hessian term bit for bit at C = 1 and at rtol 1e-5 otherwise, K1s
    (atomics) at rtol 1e-5 and atol 1e-5 times max(1, the largest entry);
    normalized (both conventions), pixel and pile-up coordinates, runs of
    40 points in one cell and ray-ordered points (the lanes of a warp on
    one texel: K1s's merged atomics, K1g's per-sample reductions), one
    point and 1000, a cotangent zero on one row in three, each term alone
    (the other's cotangent None), and an image and coordinates off their
    alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(300 + 10 * C + V)
    dev = torch.device("cuda")
    H, W = 23, 31
    numel = V * H * W * C
    imgs = [torch.randn(V, H, W, C, generator=g).to(dev),
            torch.randn(numel + 1, generator=g).to(dev)[1:].view(V, H, W, C)]
    _build.reset_launches()
    n_g = n_s = 0
    for img in imgs:
        for N in (1, 1000):
            for what, co, kw in _k1_cases(g, V, N, H, W) + _k1_shared_cases(g, V, N, H, W):
                co = torch.cat([torch.zeros(1), co.reshape(-1)]).to(dev)[1:].view(V, N, 2) \
                    if img is imgs[1] else co.to(dev)
                h = torch.randn(V, N, 2, generator=g).to(dev)
                ct = torch.randn(V, N, C, generator=g)
                ct[:, ::3] = 0.0
                ct = ct.to(dev)
                for need in ((True, True), (True, False), (False, True)):
                    flags = dict(kw, need_dir=need[0], need_hess=need[1])
                    _second_order_check(
                        tgs.bilinear_sample_bwd2_gather(img, co, h, ct, **flags),
                        tgs.bilinear_sample_bwd2_gather_plain(img, co, h, ct, **flags),
                        True, C == 1)
                    n_g += 1
                _close(tgs.bilinear_sample_bwd2_scatter(img, co, h, ct, **kw).cpu().numpy(),
                       tgs.bilinear_sample_bwd2_scatter_plain(img, co, h, ct, **kw)
                       .cpu().numpy())
                n_s += 1
    torch.cuda.synchronize()
    assert _build.launches["bilinear_sample_2d_bwd2_gather"] == n_g
    assert _build.launches["bilinear_sample_2d_bwd2_scatter"] == n_s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 16])
def test_k2g_k2s_match_plain(C, dtype):
    """K2g and K2s (the second order of K2) against their plain versions on
    the card: K2g's directional term bit for bit, its Hessian term bit for
    bit at C = 1 and at rtol 1e-5 otherwise; K2s (K2b's scatter with the
    directional weights) at rtol 1e-5 and atol 1e-5 times max(1, the
    largest entry), one bf16 step for a bf16 volume's gradient, in both of
    its forms; K2's points (corners, faces, outside, a z run) and K2b's
    cases (a band, the whole volume, a pile-up, a zero cotangent), both
    ``align_corners`` and pixel coordinates, each K2g term alone, a volume
    and a cotangent off their allocation's alignment (at C = 4 and 16 they
    take the forms for unaligned rows).  At every C but 1, K2s's counts
    equal ``chip_smoke.k2s_rows``' (the rows it scatters and the atomics
    left after its merge: 16-byte ones at C = 4 and 16 on aligned rows,
    scalar ones otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import k2s_rows
    from surf_tpu_torch import _build
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(400 + C)
    dev = torch.device("cuda")
    _build.reset_launches()
    n_g = n_s = 0
    forms = (False, True) if dt == torch.bfloat16 else (False,)
    for shape in ((16, 24, 32), (13, 9, 11)):
        numel = shape[0] * shape[1] * shape[2] * C
        vols = [torch.randn(*shape, C, generator=g).to(dev, dt),
                torch.randn(numel + 1, generator=g).to(dev, dt)[1:].view(*shape, C)]
        cases = [("points", _k2_points(g, 1001), 1.0)] + _k2b_cases(g)
        for vol in vols:
            for what, co, on in cases:
                h = torch.randn(co.shape[0], 3, generator=g).to(dev)
                ct = torch.randn(co.shape[0], C, generator=g) * on
                if vol is vols[1]:
                    ct = torch.cat([torch.zeros(1), ct.reshape(-1)]).to(dev)[1:].view(-1, C)
                else:
                    ct = ct.to(dev)
                for kw in (dict(align_corners=True), dict(align_corners=False),
                           dict(normalized=False)):
                    c = ((co + 1.3) * 5.0 if "normalized" in kw else co).to(dev)
                    for need in ((True, True), (True, False), (False, True)):
                        flags = dict(kw, need_dir=need[0], need_hess=need[1])
                        _second_order_check(
                            tgs.trilinear_sample_bwd2_gather(vol, c, h, ct, **flags),
                            tgs.trilinear_sample_bwd2_gather_plain(vol, c, h, ct, **flags),
                            True, C == 1)
                        n_g += 1
                    ref = tgs.trilinear_sample_bwd2_scatter_plain(vol, c, h, ct, **kw)
                    for bricked in forms:
                        counts = torch.zeros(2, dtype=torch.int64, device=dev)
                        got = tgs.trilinear_sample_bwd2_scatter(vol, c, h, ct, bricked=bricked,
                                                                counts=counts, **kw)
                        n_s += 1
                        assert got.dtype == ref.dtype == dt
                        rtol = 2.0 ** -7 if dt == torch.bfloat16 else RTOL
                        _close(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=rtol)
                        if C != 1:
                            want = k2s_rows(vol, c, h, ct, kw.get("align_corners", True),
                                            normalized=kw.get("normalized", True))
                            assert want["vec"] == (4 if C % 4 == 0 and vol is vols[0] else 1)
                            assert counts.tolist() == [want["corner_rows"] * C,
                                                       want["atomics"]], (what, kw)
    torch.cuda.synchronize()
    assert _build.launches["trilinear_sample_3d_bwd2_gather"] == n_g
    assert _build.launches["trilinear_sample_3d_bwd2_scatter"] == n_s


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2d", "3d f32", "3d bf16"])
def test_second_order_on_the_card_matches_the_cpu(case):
    """The double backward of ``bilinear_sample_2d`` / ``trilinear_sample_3d``
    (d/d volume, d/d coords and d/d cotangent of <dV, G> + <dx, h>) on the
    card, through K1/K2, K1b/K2b and K1g/K1s/K2g/K2s, against the same on
    the CPU (plain versions) at rtol 1e-4 and atol 1e-4 times max(1, the
    largest entry); the eikonal case (the d_volume cotangent None) too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(7)
    if case == "2d":
        vol = torch.randn(3, 29, 37, 4, generator=g)
        co = torch.rand(3, 2001, 2, generator=g) * 2.4 - 1.2
        fn = tgs.bilinear_sample_2d
    else:
        vol = torch.randn(13, 17, 11, 3, generator=g)
        if case.endswith("bf16"):
            vol = vol.bfloat16()
        co = torch.rand(2001, 3, generator=g) * 2.4 - 1.2
        fn = tgs.trilinear_sample_3d
    ct = torch.randn(*co.shape[:-1], vol.shape[-1], generator=g)
    G = torch.randn(vol.shape, generator=g).to(vol.dtype).float()
    h = torch.randn(co.shape, generator=g)
    _build.reset_launches()
    for with_vol in (True, False):
        res = {}
        for dev in ("cpu", "cuda"):
            v = vol.to(dev).requires_grad_()
            c = co.to(dev).requires_grad_()
            t = ct.to(dev).requires_grad_()
            dv, dc = torch.autograd.grad(fn(v, c, align_corners=True), (v, c), t,
                                         create_graph=True)
            L = (dc * h.to(dev)).sum() + ((dv.float() * G.to(dev)).sum() if with_vol else 0)
            res[dev] = torch.autograd.grad(L, (v, c, t))
        for a, b in zip(res["cuda"], res["cpu"]):
            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
            _close(a.float().cpu().numpy(), b.float().numpy(), rtol=rtol, atol=1e-4)
    torch.cuda.synchronize()
    base = "bilinear_sample_2d" if case == "2d" else "trilinear_sample_3d"
    names = [base + sfx for sfx in ("", "_bwd", "_bwd2_gather", "_bwd2_scatter")]
    assert all(_build.launches[n] > 0 for n in names), dict(_build.launches)


K3_SPECS = {"4 stages C=7": ((32, 0.3, 7), (16, 0.5, 7), (8, 0.7, 7), (4, 0.9, 7)),
            "C=1,5,8": ((16, 0.4, 1), (8, 0.6, 5), (4, 1.0, 8)),
            "one stage C=8": ((8, 0.5, 8),)}


def _k3_stages(g, dev, spec):
    """Random stages with absent parents (and capacity padding rows that
    the parent table never points to) and absent children."""
    stages = []
    for res, keep, C in spec:
        half = res // 2
        r = torch.arange(half)
        allp = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        parents = allp[torch.rand(len(allp), generator=g) < keep]
        n_live = len(parents)
        parents = torch.cat([parents, torch.randint(0, half, (5, 3), generator=g)])
        pvalid = torch.arange(len(parents)) < n_live
        cvalid = (torch.rand(len(parents) * 8, generator=g) < 0.8) & pvalid.repeat_interleave(8)
        grid = tsp.make_grid(parents.to(dev), pvalid.to(dev), cvalid.to(dev), res)
        stages.append((grid, (torch.randn(len(parents) * 8, C, generator=g)
                              * cvalid[:, None]).to(dev)))
    return stages


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["value", "derivs", "third"])
@pytest.mark.parametrize("spec", list(K3_SPECS))
def test_k3_matches_plain_bit_for_bit(spec, mode):
    """K3 against its plain version at 1 to 4 stages, equal bit for bit
    with the occupancy equal: value only (the mesh), derivatives (the
    render) and the training variant; points on voxel centres (cell faces),
    on the box's faces and corners and outside it; one point and 3001 (no
    multiple of the block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(len(spec) + len(mode))
    dev = torch.device("cuda")
    stages = _k3_stages(g, dev, K3_SPECS[spec])
    res = stages[0][0].res
    pts = torch.rand(3001, 3, generator=g) * 2.3 - 1.15
    pts[:300] = torch.randint(0, res, (300, 3), generator=g).float() * (2.0 / (res - 1)) - 1.0
    pts[300:304] = torch.tensor([[-1.0] * 3, [1.0] * 3, [1.0, -1.0, 0.0], [0.0, 1.0, -1.0]])
    pts = pts.to(dev)
    kw = dict(derivs=mode == "derivs", third=mode == "third")
    _build.reset_launches()
    n_calls = 0
    for ns in range(1, len(stages) + 1):
        for n in (1, 3001):
            got = tsp.sparse_trilinear_multi(stages[:ns], pts[:n], **kw)
            ref = tsp.sparse_trilinear_multi_plain(stages[:ns], pts[:n], **kw)
            n_calls += 1
            assert len(got) == len(ref)
            for name, a, b in zip(("feats", "occ", "jac", "hmix", "third"), got, ref):
                assert (a is None) == (b is None), name
                if b is not None:
                    assert torch.equal(a, b), (spec, ns, n, mode, name)
    torch.cuda.synchronize()
    assert _build.launches["sparse_trilinear_multi"] == n_calls


K3B_SUBSETS = [m for m in range(1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("subset", K3B_SUBSETS)
def test_k3b_matches_plain(subset):
    """K3b against its plain version on the card for every subset of the
    four cotangents (bit i of ``subset``: feats, jac, hmix, third; the rest
    None), at 1 to 4 stages of ``K3_SPECS`` (absent parents and children,
    capacity padding rows), on ray-ordered points whose neighbours share
    corner rows, points on voxel centres, on the box's faces (clamped
    corners) and outside it; one point and 3001 (no multiple of the
    block); the Jacobian's cotangent with its last two axes transposed, as
    the training graph gives it.  Atomics: rtol 1e-5, atol 1e-5 times
    max(1, the largest entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    g = torch.Generator().manual_seed(70 + subset)
    dev = torch.device("cuda")
    _build.reset_launches()
    n_calls = 0
    for spec in K3_SPECS.values():
        stages = _k3_stages(g, dev, spec)
        res = stages[0][0].res
        t = torch.linspace(0.0, 1.0, 100)
        rays = (torch.rand(10, 1, 3, generator=g) * 1.4 - 0.7
                + t[None, :, None] * torch.tensor([0.1, -0.05, 0.2])).reshape(-1, 3)
        pts = torch.cat([rays, torch.rand(2001, 3, generator=g) * 2.3 - 1.15])
        pts[1000:1300] = torch.randint(0, res, (300, 3), generator=g).float() \
            * (2.0 / (res - 1)) - 1.0
        pts[1300:1304] = torch.tensor([[-1.0] * 3, [1.0] * 3, [1.0, -1.0, 0.0],
                                       [0.0, 1.0, -1.0]])
        pts = pts.to(dev)
        n, C = pts.shape[0], sum(s.shape[1] for _, s in stages)
        cts = [torch.randn(*sh, generator=g).to(dev) if (subset >> i) & 1 else None
               for i, sh in enumerate(((n, C), (n, 3, C), (n, 3, C), (n, C)))]
        if cts[1] is not None:
            # the Jacobian's cotangent as the training graph hands it over:
            # its last two axes transposed (read through its strides)
            cts[1] = cts[1].transpose(1, 2).contiguous().transpose(1, 2)
        for m in (1, n):
            sub = [None if c is None else c[:m] for c in cts]
            got = tsp.sparse_trilinear_multi_bwd(stages, pts[:m], *sub)
            ref = tsp.sparse_trilinear_multi_bwd_plain(stages, pts[:m], *sub)
            n_calls += 1
            assert len(got) == len(stages)
            for a, b in zip(got, ref):
                _close(a.cpu().numpy(), b.cpu().numpy())
    torch.cuda.synchronize()
    assert _build.launches["sparse_trilinear_multi_bwd"] == n_calls


@contextlib.contextmanager
def plain_versions():
    """Every kernel's wrapper replaced by its plain PyTorch version (the
    callers and the autograd functions look the wrappers up as module
    attributes at call time), so the same code runs with no kernel."""
    swaps = [(tgs, "bilinear_sample", tgs.bilinear_sample_plain),
             (tgs, "bilinear_sample_bwd", tgs.bilinear_sample_bwd_plain),
             (tgs, "trilinear_sample", tgs.trilinear_sample_plain),
             (tgs, "trilinear_sample_bwd", tgs.trilinear_sample_bwd_plain),
             (tsp, "sparse_trilinear_multi", tsp.sparse_trilinear_multi_plain),
             (tsp, "sparse_trilinear_multi_bwd", tsp.sparse_trilinear_multi_bwd_plain),
             (trn, "gather_conv", trn.gather_conv_plain),
             (trn, "gather_conv_dw", trn.gather_conv_dw_plain)]
    swaps += [(tgs, attr, getattr(tgs, attr + "_plain"))
              for attr in ("bilinear_sample_bwd2_gather", "bilinear_sample_bwd2_scatter",
                           "trilinear_sample_bwd2_gather", "trilinear_sample_bwd2_scatter")]
    orig = [getattr(m, n) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), f in zip(swaps, orig):
            setattr(m, n, f)


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu():
    """loss.backward() of the tiny model on the card (K1b, K2b, K3b, K4w),
    unperturbed, against the same step on the card with every kernel
    swapped for its plain version (gradient leaves within 1e-3 of their
    scale: atomics and sums in another order) and on the CPU (loss terms
    rtol 1e-4; gradient leaves 5e-3: the card's own PyTorch ops move the
    SDF net's gradients by about 2e-3 from the CPU's), plus 1e-6 for the
    three leaves whose gradient is 0 by softmax shift invariance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch import _build
    from surf_tpu_torch.card import set_numerics
    set_numerics()
    tconf = ConfigFactory.parse_string(TINY)
    runs = {}
    for name in ("cpu", "cuda", "cuda plain"):
        dev = name.split()[0]
        if dev == "cpu":
            tr = Trainer(tconf, device="cpu")
            init = (tckpt.to_numpy_tree(tr.params), tckpt.to_numpy_tree(tr.state))
        else:
            tr = Trainer(tconf, device="cuda", params=tckpt.to_torch_tree(init[0], dev),
                         state=tckpt.to_torch_tree(init[1], dev))
        tr.static["dense_unet_max_res"] = 16
        tr.static["implicit_surface"] = dict(tr.static["implicit_surface"], perturb=0.0)
        batch = to_device(tr.dataset[0], dev)
        _build.reset_launches()
        with plain_versions() if name.endswith("plain") else contextlib.nullcontext():
            res, _ = tr.loss(batch, 1.0, 0.5, perturb=False,
                             pts_random=torch.linspace(-0.9, 0.9, 3072).reshape(1024, 3).to(dev))
            res["loss"].backward()
        runs[name] = (res, dict(_build.launches),
                      [(p, t.grad.cpu().numpy()) for p, t in _paths(tr.params)])
    for k in ("bilinear_sample_2d_bwd", "trilinear_sample_3d_bwd",
              "sparse_trilinear_multi_bwd", "gather_conv_dw"):
        assert runs["cuda"][1][k] > 0 and runs["cuda plain"][1][k] == 0, k
    for k in runs["cpu"][0]:
        a, b = (float(v.detach()) if torch.is_tensor(v) else float(v)
                for v in (runs["cuda"][0][k], runs["cpu"][0][k]))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=k)
    for ref, rel in (("cuda plain", 1e-3), ("cpu", 5e-3)):
        for (path, ga), (_, gb) in zip(runs["cuda"][2], runs[ref][2]):
            assert np.abs(ga - gb).max() <= rel * np.abs(gb).max() + 1e-6, (ref, path)


def _k4_table(g, R, T, M, p_row, p_tap):
    """(R, T) int32 table: a share ``p_row`` of the rows hold taps, each
    present with probability ``p_tap``; absent taps -1."""
    live = torch.rand(R, generator=g) < p_row
    present = (torch.rand(R, T, generator=g) < p_tap) & live[:, None]
    j = torch.randint(0, M, (R, T), generator=g)
    return torch.where(present, j, torch.full_like(j, -1)).to(torch.int32), live


def _k4_check(x, idx, w, ct, live=None):
    """K4 and K4w on the card against their plain versions (f32 sums in
    another order, K4w's with atomics: rtol 1e-5, atol 1e-4 times
    max(1, the largest entry)); K4 called twice must agree bit for bit."""
    dev = torch.device("cuda")
    xd, idd, wd, cd = (t.to(dev) for t in (x, idx, w, ct))
    ld = None if live is None else live.to(dev)
    out = trn.gather_conv(xd, idd, wd, ld)
    again = trn.gather_conv(xd, idd, wd, ld)
    dw = trn.gather_conv_dw(xd, idd, cd, ld)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    x = x.cpu()
    _close(out.cpu().numpy(), trn.gather_conv_plain(x, idx, w, live).numpy(), atol=1e-4)
    _close(dw.cpu().numpy(), trn.gather_conv_dw_plain(x, idx, ct, live).numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 16), (16, 16), (16, 32), (32, 16)])
@pytest.mark.parametrize("mask", ["none", "live rows", "drops rows with taps"])
def test_k4_k4w_at_the_path_widths(cin, cout, mask):
    """K4 and K4w at each (Cin, Cout) of apply_hybrid, on a table where a
    third of the rows hold taps, each present with probability 0.6; with
    no mask, the mask of the rows holding taps, or a mask that also
    leaves out some of those (they then read nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(cin * 100 + cout)
    M, R = 4099, 5003
    idx, live = _k4_table(g, R, 27, M, 0.33, 0.6)
    if mask == "drops rows with taps":
        live = live & (torch.rand(R, generator=g) < 0.7)
    x = torch.randn(M, cin, generator=g)
    w = torch.randn(27, cin, cout, generator=g)
    ct = torch.randn(R, cout, generator=g)
    _k4_check(x, idx, w, ct, None if mask == "none" else live)


K4_RAGGED = {
    "T 8, Cin 5, Cout 7": (8, 5, 7, "random"),
    "T 27, Cin 1, Cout 3": (27, 1, 3, "random"),
    "T 13, Cin 13, Cout 1": (13, 13, 1, "random"),
    "T 27, Cin 13, Cout 7": (27, 13, 7, "random"),
    "T 27, Cin 32, Cout 32": (27, 32, 32, "random"),
    "T 27, Cin 32, Cout 5": (27, 32, 5, "random"),
    "all -1": (27, 16, 8, "empty"),
    "one row read by every row and tap": (27, 16, 8, "one row"),
    "every tap present on every row": (27, 16, 8, "full"),
    "Cin 16 off its 16-byte alignment": (27, 16, 8, "unaligned"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_RAGGED))
@pytest.mark.parametrize("with_live", [False, True])
def test_k4_k4w_ragged(case, with_live):
    """K4 and K4w on ragged shapes and extreme tables, R = 1001 rows (no
    multiple of the 32-row group), with and without a live-row mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    T, cin, cout, kind = K4_RAGGED[case]
    g = torch.Generator().manual_seed(len(case) * 7 + T)
    M, R = 517, 1001
    idx, live = _k4_table(g, R, T, M, 0.5, 0.5)
    if kind == "empty":
        idx = torch.full((R, T), -1, dtype=torch.int32)
    elif kind == "one row":
        idx = torch.full((R, T), 3, dtype=torch.int32)
    elif kind == "full":
        idx = torch.randint(0, M, (R, T), generator=g).to(torch.int32)
    if kind in ("one row", "full", "empty"):
        live = torch.rand(R, generator=g) < 0.8
    x = torch.randn(M, cin, generator=g)
    w = torch.randn(T, cin, cout, generator=g)
    ct = torch.randn(R, cout, generator=g)
    if kind == "unaligned":
        # a view one float into its storage: Cin % 4 == 0, rows off 16 bytes
        x = torch.randn(M * cin + 1, generator=g).to("cuda")[1:].reshape(M, cin)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _k4_check(x, idx, w, ct, live if with_live else None)


@pytest.mark.cuda
def test_dtu_layout_validate_on_the_card(tmp_path, monkeypatch):
    """The tiny model's validate on a DTU-layout scene (written by
    ``data.dtu_scene`` at 96x128, read by ``DTUDataset`` at 48x64) with
    ``clean_mesh`` on, on the card against the same on the CPU, the render
    unperturbed and the hybrid U-Net at stage 1: K1-K4 launched; colour, normal and depths within 1e-4
    (the tiny model's card-against-CPU tolerance); a
    non-empty mesh that cleaning does not grow; the PNG and ``.npy``
    artifacts written."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import re
    from surf_tpu_torch import _build, validate
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.data.dtu_scene import write_dtu_scene
    set_numerics()
    root = write_dtu_scene(str(tmp_path / "scene"), image_hw=(96, 128))
    conf = ConfigFactory.parse_string(re.sub(
        r"val_dataset \{[^}]*\}\n", "val_dataset {\n dataset_name = DTUDataset\n"
        f" data_dir = {root}\n scene = [scan24]\n ref_view = [0]\n light_idx = [3]\n"
        " num_src_view = 2\n val_res_level = 4\n factor = 1.0\n interval_scale = 1\n"
        " num_interval = 192\n img_hw = [48, 64]\n}\n", TINY, count=1))
    arrays, write = {}, validate.write_artifacts
    runs = {}
    for dev in ("cpu", "cuda"):
        def recorded(*args, dev=dev):
            arrays[dev] = args[3:]
            return write(*args)
        monkeypatch.setattr(validate, "write_artifacts", recorded)
        kw = {} if dev == "cpu" else {"params": tckpt.to_torch_tree(init[0], dev),
                                      "state": tckpt.to_torch_tree(init[1], dev)}
        v = validate.Validator(conf, device=dev, mesh_resolution=32, clean_mesh=True,
                               base_exp_dir=str(tmp_path / dev), **kw)
        if dev == "cpu":
            init = (tckpt.to_numpy_tree(v.params), tckpt.to_numpy_tree(v.state))
        v.static["implicit_surface"] = dict(v.static["implicit_surface"], perturb=0.0)
        v.static["dense_unet_max_res"] = 16     # the hybrid U-Net at stage 1: K4 runs
        _build.reset_launches()
        (runs[dev],) = v.validate()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.launches)
    for k in ("bilinear_sample_2d", "trilinear_sample_3d", "sparse_trilinear_multi",
              "gather_conv"):
        assert launches[k] > 0, k
    for got, ref in zip(arrays["cuda"], arrays["cpu"]):
        _close(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for m in runs.values():
        assert m["finite"] and 0 < m["mesh_faces"] <= m["mesh_faces_before_clean"]
    for sub, ext in (("val_img", "png"), ("val_normal", "png"), ("val_sdf_depth", "npy"),
                     ("val_render_depth", "png"), ("val_auxi_depth", "npy")):
        assert (tmp_path / "cuda" / sub / f"scan24_view0_light3_epoch0.{ext}").exists()


MVS_CASES = {  # views as the confs name them; file and loader sizes
    "BMVSDataset": ("59e864b2a9e91f2c5529325f", [1, 0, 2], (96, 128), (48, 64), 100, 1.0),
    "TanksDataset": ("Family", [36, 34, 35, 37, 38], (54, 96), (36, 64), 150, 0.8),
    "ETH3DDataset": ("facade", [22, 19, 20, 21, 23, 24, 25], (64, 96), (48, 96), 180, 0.8)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MVS_CASES))
def test_mvs_layout_validate_on_the_card(tmp_path, monkeypatch, name):
    """The tiny model's validate on a scene in ``name``'s JPEG layout
    (written by ``data.mvs_scene``, read by ``GenericMVSDataset``) with
    ``clean_mesh`` on, on the card against the same on the CPU, as the DTU
    test above: K1-K4 launched; colour, normal and depths within 1e-4; a
    non-empty mesh that cleaning does not grow; the artifacts written."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import re
    from surf_tpu_torch import _build, validate
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.data.mvs_scene import write_mvs_scene
    set_numerics()
    scan, views, file_hw, img_hw, num_interval, factor = MVS_CASES[name]
    root = write_mvs_scene(str(tmp_path / "scene"), name, scan, sorted(views),
                           image_hw=file_hw)
    conf = ConfigFactory.parse_string(re.sub(
        r"val_dataset \{[^}]*\}\n", f"val_dataset {{\n dataset_name = {name}\n"
        f" data_dir = {root}\n scene = [{scan}]\n ref_view = [{views[0]}]\n"
        f" src_views = {views[1:]}\n num_src_view = {len(views) - 1}\n val_res_level = 4\n"
        f" factor = {factor}\n interval_scale = 1\n num_interval = {num_interval}\n"
        f" img_hw = [{img_hw[0]}, {img_hw[1]}]\n}}\n", TINY, count=1))
    arrays, write = {}, validate.write_artifacts
    runs = {}
    for dev in ("cpu", "cuda"):
        def recorded(*args, dev=dev):
            arrays[dev] = args[3:]
            return write(*args)
        monkeypatch.setattr(validate, "write_artifacts", recorded)
        kw = {} if dev == "cpu" else {"params": tckpt.to_torch_tree(init[0], dev),
                                      "state": tckpt.to_torch_tree(init[1], dev)}
        v = validate.Validator(conf, device=dev, mesh_resolution=32, clean_mesh=True,
                               base_exp_dir=str(tmp_path / dev), **kw)
        if dev == "cpu":
            init = (tckpt.to_numpy_tree(v.params), tckpt.to_numpy_tree(v.state))
        v.static["implicit_surface"] = dict(v.static["implicit_surface"], perturb=0.0)
        v.static["dense_unet_max_res"] = 16     # the hybrid U-Net at stage 1: K4 runs
        _build.reset_launches()
        (runs[dev],) = v.validate()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.launches)
    for k in ("bilinear_sample_2d", "trilinear_sample_3d", "sparse_trilinear_multi",
              "gather_conv"):
        assert launches[k] > 0, k
    for got, ref in zip(arrays["cuda"], arrays["cpu"]):
        _close(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for m in runs.values():
        assert m["finite"] and 0 < m["mesh_faces"] <= m["mesh_faces_before_clean"]
    for sub, ext in (("val_img", "png"), ("val_normal", "png"), ("val_sdf_depth", "npy"),
                     ("val_render_depth", "png"), ("val_auxi_depth", "npy")):
        assert (tmp_path / "cuda" / sub / f"{scan}_view{views[0]}_epoch0.{ext}").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bilinear_sample_2d", "bilinear_sample_2d_bwd",
                                  "trilinear_sample_3d", "trilinear_sample_3d_bwd",
                                  "sparse_trilinear_multi", "sparse_trilinear_multi_bwd",
                                  "gather_conv", "gather_conv_dw",
                                  "bilinear_sample_2d_bwd2_gather",
                                  "bilinear_sample_2d_bwd2_scatter",
                                  "trilinear_sample_3d_bwd2_gather",
                                  "trilinear_sample_3d_bwd2_scatter",
                                  "sdf_lattice_mlp", "marching_cubes_lattice"])
def test_kernels_launch_on_their_tensors_card(name):
    """A rank whose current card is cuda:0 and whose tensors are on cuda:1
    (no ``set_device``): every wrapper launches its kernel on cuda:1 and
    matches its plain version; tensors on two cards are refused."""
    from test_torch_contract import _calls
    from surf_tpu_torch import _build
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    before = _build.launches[name]
    with torch.cuda.device(0):
        got = _calls("cuda:1")[name]()
        torch.cuda.synchronize(1)
    assert _build.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = _calls("cpu")[name]()
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        if r is not None:
            assert g.device == torch.device("cuda", 1)
            torch.testing.assert_close(g.cpu().float(), r.float(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cards"):
        _build.require_cuda(name, torch.zeros(1, device="cuda:0"),
                            torch.zeros(1, device="cuda:1"))
