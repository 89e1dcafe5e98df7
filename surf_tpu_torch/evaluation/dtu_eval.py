"""The DTU Chamfer evaluation, with numpy and scipy: the port of
evaluation/dtu_eval.py (open3d- and sklearn-free, as that script is).

Sample each cleaned mesh's triangles on a barycentric lattice at
``downsample_density`` spacing, radius-downsample the cloud, keep the
points in the official ``ObsMask`` and bounding box, and report the mean
of the data-to-STL and STL-to-data distances (the STL points above the
ground ``Plane``), each truncated at ``max_dist``, over the 15 DTU test
scans; ``results.json`` holds each scan's numbers and their mean:

    python -m surf_tpu_torch.evaluation.dtu_eval --out_dir <exp> \\
        --dataset_dir <dtu_training/evaluation>

It reads ``<exp>/meshes/final/scan{N}.ply`` (``clean_mesh``'s output) and
``ObsMask/ObsMask{N}_10.mat``, ``ObsMask/Plane{N}.mat`` and
``Points/stl/stl{N:03}_total.ply`` under ``dataset_dir``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy.io import loadmat
from scipy.spatial import cKDTree

from ..io.ply import read_ply

SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]


def sample_mesh_points(vertices, triangles, thresh):
    """The vertices, then each triangle sampled on a barycentric lattice of
    about ``thresh`` spacing (``n1 x n2`` steps along its two edges from
    vertex 0; triangles grouped by lattice shape)."""
    tri = vertices[triangles]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    keep = area2 > 0
    tri, v1, v2, l1, l2, area2 = tri[keep], v1[keep], v2[keep], l1[keep], l2[keep], area2[keep]
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)
    out = [vertices]
    order = np.lexsort((n2, n1))
    n1s, n2s = n1[order], n2[order]
    bounds = np.flatnonzero(np.diff(n1s) | np.diff(n2s)) + 1
    for grp in np.split(order, bounds):
        if len(grp) == 0:
            continue
        a, b = int(n1[grp[0]]), int(n2[grp[0]])
        if a <= 0 or b <= 0:
            continue
        u, v = np.meshgrid(np.arange(a + 1) / a, np.arange(b + 1) / b, indexing="ij")
        m = (u + v) <= 1.0
        u, v = u[m], v[m]
        pts = (tri[grp, None, 0] + u[None, :, None] * v1[grp, None]
               + v[None, :, None] * v2[grp, None]).reshape(-1, 3)
        out.append(pts)
    return np.concatenate(out, axis=0)


def radius_downsample(pts, radius, seed=0):
    """Greedy radius downsample in a seeded random order: a point survives
    unless an earlier survivor lies within ``radius``.

    Computed from the proximity graph (``query_pairs``, every pair i < j
    within ``radius`` in the shuffled order): a live point i kills its
    later neighbours j > i; an earlier neighbour of i is dead already
    (alive, it would have killed i), so these kills are all the
    per-point ball loop makes."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    # the sliding-midpoint build: faster than the balanced median build on
    # a DTU-size cloud, and query_pairs costs the same
    tree = cKDTree(pts, balanced_tree=False, compact_nodes=False)
    pairs = tree.query_pairs(radius, output_type="ndarray")
    alive = np.ones(len(pts), bool)
    if len(pairs):
        order = np.argsort(pairs[:, 0], kind="stable")
        ii = pairs[order, 0]
        jj = pairs[order, 1]
        starts = np.flatnonzero(np.diff(ii)) + 1
        starts = np.concatenate([[0], starts, [len(ii)]])
        for k in range(len(starts) - 1):
            s = starts[k]
            if alive[ii[s]]:
                alive[jj[s:starts[k + 1]]] = False
    return pts[alive]


def eval_scan(scan, out_dir, dataset_dir, thresh=0.2, max_dist=20.0, patch=60.0):
    """(mean data-to-STL, mean STL-to-data, their mean) of scan ``scan``,
    in the STL's units (mm)."""
    mesh_path = os.path.join(out_dir, "meshes", "final", f"scan{scan}.ply")
    m = read_ply(mesh_path)
    data_pcd = sample_mesh_points(m["vertices"], m["faces"], thresh)

    data_down = radius_downsample(data_pcd, thresh)

    obs = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scan}_10.mat")
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = ((data_down >= BB[:1] - patch) & (data_down < BB[1:] + patch * 2)).sum(-1) == 3
    data_in = data_down[inbound]
    grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    gin = ((grid >= 0) & (grid < np.expand_dims(ObsMask.shape, 0))).sum(-1) == 3
    gi = grid[gin]
    in_obs = ObsMask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
    data_in_obs = data_in[gin][in_obs]

    stl = read_ply(f"{dataset_dir}/Points/stl/stl{scan:03}_total.ply")["vertices"]

    d2s = cKDTree(stl, balanced_tree=False,
                  compact_nodes=False).query(data_in_obs, k=1, workers=-1)[0]
    mean_d2s = d2s[d2s < max_dist].mean()

    plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scan}.mat")["P"]
    above = (np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
             @ plane.reshape(4)) > 0
    s2d = cKDTree(data_in, balanced_tree=False,
                  compact_nodes=False).query(stl[above], k=1, workers=-1)[0]
    mean_s2d = s2d[s2d < max_dist].mean()

    return float(mean_d2s), float(mean_s2d), float((mean_d2s + mean_s2d) / 2)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_dir", type=str, default="./outputs")
    parser.add_argument("--dataset_dir", type=str,
                        default="./data/dtu_training/evaluation")
    parser.add_argument("--downsample_density", type=float, default=0.2)
    parser.add_argument("--max_dist", type=float, default=20.0)
    parser.add_argument("--patch_size", type=float, default=60.0)
    args = parser.parse_args(argv)

    results = {}
    overall = []
    for scan in SCANS:
        d2s, s2d, ov = eval_scan(scan, args.out_dir, args.dataset_dir,
                                 args.downsample_density, args.max_dist,
                                 args.patch_size)
        results[f"scan{scan}"] = {"mean_d2s": d2s, "mean_s2d": s2d, "overall": ov}
        overall.append(ov)
        print(f"scan{scan}: d2s={d2s:.4f} s2d={s2d:.4f} overall={ov:.4f}")
    results["mean"] = float(np.mean(overall))
    print(f"mean chamfer: {results['mean']:.4f}")
    with open(os.path.join(args.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
