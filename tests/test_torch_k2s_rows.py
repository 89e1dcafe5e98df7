"""``chip_smoke.k2s_rows``, the count of what K2s's rows form (C other
than 1) scatters, against a brute-force count that walks the samples one
by one in numpy float32: the (sample, corner) rows added (a nonzero
cotangent row, the corner inside, its directional weight nonzero), the
rows left after each warp's 32 consecutive samples are merged (runs of
lanes in one cell) and the atomics (C / 4 16-byte ones a row at C = 16,
C scalar ones at C = 5).  Exact integer counts; no JAX."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import k2s_rows  # noqa: E402

SIDE = 12
F = np.float32


def _brute(co, h, ct, align, normalized):
    X = Y = Z = SIDE
    C = ct.shape[1]
    sizes = (X, Y, Z)
    if not normalized:
        scale = [F(1.0)] * 3
    else:
        scale = [F(0.5 * (n - 1)) if align else F(0.5 * n) for n in sizes]
    rows, merged = 0, set()
    prev, run = None, 0
    for p in range(co.shape[0]):
        u = []
        for a, n in enumerate(sizes):
            c = F(co[p, a])
            if normalized:
                c = ((c + F(1.0)) * F(0.5) * F(n - 1) if align
                     else ((c + F(1.0)) * F(n) - F(1.0)) * F(0.5))
            u.append(c)
        lo = [np.floor(c) for c in u]
        fr = [u[a] - lo[a] for a in range(3)]
        hp = [F(h[p, a]) * scale[a] for a in range(3)]
        nz = bool((ct[p] != 0).any())
        corners = []
        for k in range(8):
            o = ((k >> 2) & 1, (k >> 1) & 1, k & 1)
            idx = [int(lo[a]) + o[a] for a in range(3)]
            inside = all(0 <= idx[a] < sizes[a] for a in range(3))
            w = [fr[a] if o[a] else F(1.0) - fr[a] for a in range(3)]
            e = [F(1.0) if o[a] else F(-1.0) for a in range(3)]
            dw = (((w[1] * w[2]) * e[0]) * hp[0] + ((w[0] * w[2]) * e[1]) * hp[1]
                  + ((w[0] * w[1]) * e[2]) * hp[2])
            corners.append(inside and nz and dw != 0)
        # a run: consecutive lanes of one warp in one cell that has a corner
        # inside, with nonzero cotangents; any other sample is a run alone
        has_cell = nz and any(all(0 <= int(lo[a]) + ((k >> (2 - a)) & 1) < sizes[a]
                                  for a in range(3)) for k in range(8))
        key = tuple(int(x) for x in lo) if has_cell else ("alone", p)
        if p % 32 == 0 or key != prev:
            run += 1
        prev = key
        for k, on in enumerate(corners):
            if on:
                rows += 1
                merged.add((k, run))
    vec = 4 if C % 4 == 0 else 1
    return {"corner_rows": rows, "rows_after_warp_merge": len(merged), "vec": vec,
            "atomics": len(merged) * C // vec}


def _points(rng, normalized):
    """500 points: 10 rays of 30 samples a quarter voxel apart (runs of
    lanes in one cell), a pile-up of 60 in one cell, 100 over and beyond
    the volume, and 40 on the lattice's planes (a zero fraction: weights
    and directional weights exactly 0 at some corners)."""
    X = SIDE
    start = rng.uniform(1.0, X - 4.0, (10, 1, 3))
    step = rng.uniform(-1.0, 1.0, (10, 1, 3))
    step *= 0.25 / np.linalg.norm(step, axis=-1, keepdims=True)
    rays = (start + step * np.arange(30)[None, :, None]).reshape(-1, 3)
    pile = np.array([4.3, 6.6, 2.2]) + rng.uniform(0.0, 0.5, (60, 3))
    spread = rng.uniform(-2.0, X + 1.0, (100, 3))
    lattice = rng.uniform(0.0, X - 1.0, (40, 3))
    axis = (np.arange(40), rng.randint(0, 3, 40))
    lattice[axis] = np.floor(lattice[axis])
    pix = np.concatenate([rays, pile, spread, lattice]).astype(np.float32)
    if not normalized:
        return pix
    # [-1, 1] with align_corners=True (some lattice points come back to
    # exact integers; with half-texel centres none do)
    return (pix / (X - 1) * 2.0 - 1.0).astype(np.float32)


@pytest.mark.parametrize("C", [16, 5])
@pytest.mark.parametrize("coords", ["align_corners", "half_texel", "pixel"])
def test_k2s_rows_matches_brute_force_count(coords, C):
    rng = np.random.RandomState(31)
    normalized = coords != "pixel"
    align = coords != "half_texel"
    co = _points(rng, normalized)
    h = rng.randn(co.shape[0], 3).astype(np.float32)
    h[::4, 1:] = 0.0                     # along x only: more zero weights
    ct = rng.randn(co.shape[0], C).astype(np.float32)
    ct[::7] = 0.0
    vol = torch.zeros(SIDE, SIDE, SIDE, C)
    got = k2s_rows(vol, torch.from_numpy(co), torch.from_numpy(h), torch.from_numpy(ct),
                   align, normalized=normalized)
    want = _brute(co, h, ct, align, normalized)
    assert got == want
    # the inputs exercise what the count distinguishes
    assert 0 < want["rows_after_warp_merge"] < want["corner_rows"] < 8 * co.shape[0]
