"""BVH builder property tests (SURVEY.md §4b): structural invariants,
permutation property, TLAS coverage."""

import numpy as np

from gdpathtracing.bvh.blas import BLASBuilder, Surface, validate_blas
from gdpathtracing.bvh.tlas import build_tlas, instance_world_aabb


def _random_surface(rs, n_tris, scale=1.0, offset=0.0):
    v0 = rs.uniform(-1, 1, size=(n_tris, 3)) * scale + offset
    e1 = rs.uniform(-0.2, 0.2, size=(n_tris, 3))
    e2 = rs.uniform(-0.2, 0.2, size=(n_tris, 3))
    pos = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)
    return Surface(positions=pos)


def test_blas_invariants_random():
    rs = np.random.RandomState(0)
    b = BLASBuilder()
    root = b.build_mesh([_random_surface(rs, 500)])
    arrays = b.finalize()
    validate_blas(arrays, root)


def test_blas_all_negative_geometry():
    # Regression for the reference's numeric_limits<float>::min() AABB-init
    # bug (bvh.cpp:6-10) — all-negative coordinates must still bound.
    rs = np.random.RandomState(1)
    b = BLASBuilder()
    root = b.build_mesh([_random_surface(rs, 64, scale=0.5, offset=-10.0)])
    arrays = b.finalize()
    validate_blas(arrays, root)
    assert (arrays.node_max[root] < 0).all()


def test_blas_triangles_are_permutation():
    rs = np.random.RandomState(2)
    surf = _random_surface(rs, 100)
    b = BLASBuilder()
    b.build_mesh([surf])
    arrays = b.finalize()
    orig = np.sort(surf.positions.reshape(100, -1).sum(axis=1))
    got = np.sort(arrays.tri_pos.reshape(100, -1).sum(axis=1))
    assert np.allclose(orig, got)


def test_blas_multiple_meshes_share_pool():
    rs = np.random.RandomState(3)
    b = BLASBuilder()
    r1 = b.build_mesh([_random_surface(rs, 50)])
    r2 = b.build_mesh([_random_surface(rs, 80)])
    arrays = b.finalize()
    assert r1 != r2
    validate_blas(arrays, r1)
    validate_blas(arrays, r2)
    assert len(arrays.tri_pos) == 130


def test_blas_material_slots():
    rs = np.random.RandomState(4)
    surfs = [_random_surface(rs, 10), _random_surface(rs, 20)]
    b = BLASBuilder()
    b.build_mesh(surfs)
    arrays = b.finalize()
    # Slots survive the permutation: 10 tris slot 0, 20 tris slot 1.
    assert (arrays.tri_slot == 0).sum() == 10
    assert (arrays.tri_slot == 1).sum() == 20


def test_blas_degenerate_identical_centroids():
    # All triangles identical → SAH can't split → median fallback must
    # terminate and produce ≤4-tri leaves.
    pos = np.tile(
        np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float32),
        (16, 1, 1))
    b = BLASBuilder()
    root = b.build_mesh([Surface(positions=pos)])
    arrays = b.finalize()
    validate_blas(arrays, root)


def test_tlas_structure():
    rs = np.random.RandomState(5)
    mins = [rs.uniform(-10, 0, 3).astype(np.float32) for _ in range(7)]
    maxs = [m + rs.uniform(0.1, 2, 3).astype(np.float32) for m in mins]
    tlas = build_tlas(mins, maxs)
    # Walk from root (slot 0); every instance must be reachable exactly once
    # and every parent AABB must contain its children.
    seen = []
    stack = [0]
    visited = 0
    while stack:
        i = stack.pop()
        visited += 1
        assert visited < 100
        if tlas.node_left[i] == 0:
            seen.append(int(tlas.node_inst[i]))
        else:
            for c in (int(tlas.node_left[i]), int(tlas.node_right[i])):
                assert (tlas.node_min[c] >= tlas.node_min[i] - 1e-4).all()
                assert (tlas.node_max[c] <= tlas.node_max[i] + 1e-4).all()
                stack.append(c)
    assert sorted(seen) == list(range(7))


def test_tlas_single_instance():
    tlas = build_tlas([np.zeros(3, np.float32)], [np.ones(3, np.float32)])
    assert tlas.node_left[0] == 0  # root is a leaf
    assert tlas.node_inst[0] == 0


def test_instance_world_aabb_rotation():
    bmin = np.array([-1, -2, -3], np.float32)
    bmax = np.array([1, 2, 3], np.float32)
    # 90° about Y: x→-z, z→x  (column convention: world = R @ local)
    t = np.array([[0, 0, 1, 5], [0, 1, 0, 0], [-1, 0, 0, 0]], np.float32)
    wmin, wmax = instance_world_aabb(t, bmin, bmax)
    assert np.allclose(wmin, [2, -2, -1], atol=1e-5)
    assert np.allclose(wmax, [8, 2, 1], atol=1e-5)
