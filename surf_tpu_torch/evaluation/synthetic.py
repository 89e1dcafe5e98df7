"""The Chamfer of meshes of the procedural synthetic scene against its
analytic sphere: ``chamfer_vs_sphere`` (as tools/train_synthetic.py has
it) and the scoring of finetune meshes (as tools/eval_finetune_meshes.py
does it):

    python -m surf_tpu_torch.evaluation.synthetic <exp_dir> \\
        [--conf confs/surf_synthetic_finetune.conf]

scores every ``<exp_dir>/meshes/<scene>_step<N>.ply`` that
``Finetuner.validate_finetune`` writes (in the scene's frame): each is
mapped back to the normalized frame by the inverse of the scene's
``scale_mat``, cleaned by ``geometry.clean_mesh`` against the conf's
``finetune_dataset`` scene (its masks and cameras), and scored against the
``SyntheticDataset`` sphere, in step order.

The JAX tool maps back with ``(v - t) / scale_mat[0, 0]``, which is the
inverse only when ``scale_mat`` has no rotation; the synthetic scene's
holds the reference camera's (``w2c_ref_inv @ scale_mat``), so there every
mesh lands off the sphere and scores the truncation bound.  This port
inverts the whole matrix.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np
from scipy.spatial import cKDTree

from ..config import ConfigFactory
from ..data.synthetic import SyntheticDataset
from ..geometry.clean_mesh import clean_mesh
from ..geometry.mesh import Mesh


def chamfer_vs_sphere(verts_norm, scale_mat, radius_world, n_gt=20000,
                      seed=0, max_dist_ratio=0.2):
    """(mean mesh-to-sphere, mean sphere-to-mesh, their mean) between the
    vertices ``verts_norm`` (mapped to the world by ``scale_mat``) and the
    sphere of radius ``radius_world`` at the origin: the first direction
    exactly (| |v| - r |), the second from ``n_gt`` seeded points on the
    sphere to their nearest vertex.  Distances of ``max_dist_ratio *
    radius_world`` or more are left out of the means, as the DTU
    protocol's ``max_dist`` truncation does (a mean with nothing left is
    that bound)."""
    max_dist = max_dist_ratio * radius_world
    vw = verts_norm @ scale_mat[:3, :3].T + scale_mat[:3, 3]
    d2s = np.abs(np.linalg.norm(vw, axis=1) - radius_world)
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(n_gt, 3))
    gt = gt / np.linalg.norm(gt, axis=1, keepdims=True) * radius_world
    s2d = cKDTree(vw).query(gt, k=1)[0]
    md2s = float(d2s[d2s < max_dist].mean()) if (d2s < max_dist).any() \
        else float(max_dist)
    ms2d = float(s2d[s2d < max_dist].mean()) if (s2d < max_dist).any() \
        else float(max_dist)
    return md2s, ms2d, (md2s + ms2d) / 2


def main(argv=None):
    """Prints a line a mesh and returns its rows (step, chamfer, d2s, s2d,
    vertices after cleaning)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_dir", help="finetune base_exp_dir (contains meshes/)")
    ap.add_argument("--conf", default="confs/surf_synthetic_finetune.conf")
    args = ap.parse_args(argv)

    conf = ConfigFactory.parse_file(args.conf)
    ds = SyntheticDataset(conf["finetune_dataset"], "val")
    scene = ds._build(0)
    scale_mat = np.asarray(scene["scale_mat"], np.float64)
    to_norm = np.linalg.inv(scale_mat)

    paths = sorted(glob.glob(os.path.join(args.exp_dir, "meshes", "*.ply")),
                   key=lambda p: int(re.search(r"step(-?\d+)", p).group(1)))
    if not paths:
        sys.exit(f"no meshes under {args.exp_dir}/meshes")
    rows = []
    for p in paths:
        step = int(re.search(r"step(-?\d+)", p).group(1))
        m = Mesh.load(p)
        verts_norm = m.vertices @ to_norm[:3, :3].T + to_norm[:3, 3]
        cleaned = clean_mesh(Mesh(verts_norm, m.faces), scene["masks"],
                             scene["intrs"], scene["c2ws"])
        vc = np.asarray(cleaned.vertices, np.float32)
        if not len(vc):
            print(f"step {step:>6}: EMPTY after cleaning ({p})")
            continue
        d2s, s2d, ch = chamfer_vs_sphere(vc, scale_mat, ds.radius_world)
        rows.append((step, ch, d2s, s2d, len(vc)))
        print(f"step {step:>6}: chamfer={ch:.4f} (d2s={d2s:.4f} s2d={s2d:.4f})"
              f" verts={len(vc)}  {os.path.basename(p)}")
    if len(rows) > 1:
        first, last = rows[0], rows[-1]
        print(f"\nchamfer {first[1]:.4f} (step {first[0]}) -> "
              f"{last[1]:.4f} (step {last[0]})  "
              f"[{'IMPROVED' if last[1] < first[1] else 'regressed'}]")
    return rows


if __name__ == "__main__":
    main()
