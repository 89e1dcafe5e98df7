"""The port's ``--clean_mesh`` (surf_tpu_torch/geometry/clean_mesh.py and
its BVH raycaster) against cv2 and the JAX package's ``clean_mesh``: the
elliptical structuring element and the mask dilation bit for bit, and on
a marching-cubes mesh (a sphere, a second body half outside the masks
and a small floater) with the synthetic scene's masks and cameras, the
same kept faces and vertices after each pass.  The raycaster's first-hit
triangles are equal; its hit distances within 1e-5 relative (the JAX
package compiles its copy with -march=native, so g++ may fuse
multiply-adds there)."""

import importlib

import cv2
import numpy as np
import pytest

from surf_tpu.geometry.mesh import Mesh as JMesh
from surf_tpu.geometry.raycast import RayMeshIntersector as JRays

from tiny_conf import TINY
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.data import SyntheticDataset
from surf_tpu_torch.geometry import Mesh, marching_cubes
from surf_tpu_torch.geometry.raycast import RayMeshIntersector

# the modules (each package's geometry/__init__ exports the function
# ``clean_mesh`` under the module's name)
jcm = importlib.import_module("surf_tpu.geometry.clean_mesh")
tcm = importlib.import_module("surf_tpu_torch.geometry.clean_mesh")


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5, 7, 11, 16, 25])
def test_ellipse_kernel_equals_cv2(radius):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius + 1, 2 * radius + 1))
    got = tcm.ellipse_kernel(radius)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius", [1, 4, 11])
def test_dilate_masks_equals_cv2_and_jax(radius):
    rng = np.random.RandomState(radius)
    masks = (rng.rand(3, 57, 83) > 0.993).astype(np.float32)
    masks[0, :2, :3] = 1.0            # at the borders
    masks[1, -1, -1] = 1.0
    masks[2, 20:30, 40:41] = 1.0
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius + 1, 2 * radius + 1))
    ref = np.stack([cv2.dilate((m > 0).astype(np.uint8), k) for m in masks])
    got = tcm.dilate_masks(masks, radius)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jcm.dilate_masks(masks, radius))


@pytest.fixture(scope="module")
def scene():
    item = SyntheticDataset(ConfigFactory.parse_string(TINY)["val_dataset"], "val")[0]
    n = 64
    g = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    ball = lambda c, r: np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - r
    sdf = np.minimum.reduce([ball((0, 0, 0), 0.45), ball((-0.2, 0.0, 0.6), 0.2),
                             ball((0.75, 0.75, -0.75), 0.08)])
    v, f = marching_cubes(sdf.astype(np.float32))
    return item, v / (n - 1) * 2 - 1, f


def _same(t, j):
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.vertices, j.vertices)


def test_raycaster_first_hits_equal_jax(scene):
    _, v, f = scene
    rng = np.random.RandomState(0)
    o = np.tile([[0.1, -0.2, -2.5]], (4096, 1)).astype(np.float32)
    d = rng.randn(4096, 3).astype(np.float32) * 0.2 + [0, 0, 1]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri_t, t_t = RayMeshIntersector(Mesh(v, f)).intersects_first(o, d)
    tri_j, t_j = JRays(JMesh(v, f)).intersects_first(o, d)
    assert (tri_t >= 0).sum() > 1000 and (tri_t < 0).sum() > 100
    np.testing.assert_array_equal(tri_t, tri_j)
    # the JAX package builds its copy with -march=native, where g++ may fuse
    # multiply-adds: the distances agree to float32 round-off
    np.testing.assert_allclose(t_t, t_j, rtol=1e-5, atol=0)


def test_clean_mesh_keeps_the_faces_jax_keeps(scene):
    item, v, f = scene
    masks, intrs, c2ws = item["masks"], item["intrs"], item["c2ws"]
    dil = tcm.dilate_masks(masks, 11)
    by_mask = tcm.clean_mesh_by_mask(Mesh(v, f), dil, intrs, c2ws)
    _same(by_mask, jcm.clean_mesh_by_mask(JMesh(v, f), dil, intrs, c2ws))
    assert 0 < len(by_mask.faces) < len(f)
    frustum = tcm.clean_mesh_outside_frustum(Mesh(v, f), dil, intrs, c2ws)
    _same(frustum, jcm.clean_mesh_outside_frustum(JMesh(v, f), dil, intrs, c2ws))
    got = tcm.clean_mesh(Mesh(v, f), masks, intrs, c2ws)
    ref = jcm.clean_mesh(JMesh(v, f), masks, intrs, c2ws)
    _same(got, ref)
    assert 0 < len(got.faces) < len(by_mask.faces)
    empty = tcm.clean_mesh(Mesh(v, f[:0]), masks, intrs, c2ws)
    assert len(empty.faces) == 0
