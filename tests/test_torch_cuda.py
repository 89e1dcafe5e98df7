"""The port's backward kernels and training step on the card (tests
marked ``cuda``; they skip without an NVIDIA GPU, and import no JAX, so
they run on the card's machine: ``python -m pytest tests/test_torch_cuda.py
-m cuda``).

* K1b, K2b, K3b and K4w against their plain versions on odd shapes with
  points outside the image / volume / grid;
* K1 and K1b against their plain versions at every channel count their
  kernels specialise and two they do not, one and five views, one point
  and a count that is no multiple of the block, normalized and pixel
  coordinates, points outside the image, all-zero cotangent rows, a
  pile-up on one texel, each (d_image, d_coords) combination, and
  images and coordinates off their vector alignment;
* ``loss.backward()`` of the tiny model on the card against the same step
  on the CPU (whose plain versions tests/test_torch_train.py holds against
  the JAX package)."""

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
    shapes with points outside the image / volume / grid.  The kernels sum
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
            kw = dict(align_corners=False)
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
    import contextlib
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import plain_versions
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
