"""Native C++ builder ↔ NumPy builder parity: bit-identical trees."""

import numpy as np
import pytest

from gdpathtracing.bvh import native
from gdpathtracing.bvh.blas import BLASBuilder, Surface, validate_blas

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def _random_surface(rs, n_tris, scale=1.0, offset=0.0):
    v0 = rs.uniform(-1, 1, size=(n_tris, 3)) * scale + offset
    e1 = rs.uniform(-0.3, 0.3, size=(n_tris, 3))
    e2 = rs.uniform(-0.3, 0.3, size=(n_tris, 3))
    pos = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)
    return Surface(positions=pos)


@pytest.mark.parametrize("n_tris,seed", [(16, 0), (100, 1), (977, 2),
                                         (2048, 3)])
def test_native_matches_numpy_bitwise(n_tris, seed):
    rs = np.random.RandomState(seed)
    surf = _random_surface(rs, n_tris)

    b_np = BLASBuilder(backend="numpy")
    r_np = b_np.build_mesh([surf])
    a_np = b_np.finalize()

    b_nat = BLASBuilder(backend="native")
    r_nat = b_nat.build_mesh([surf])
    a_nat = b_nat.finalize()

    assert r_np == r_nat
    assert a_np.node_min.shape == a_nat.node_min.shape, \
        (a_np.node_min.shape, a_nat.node_min.shape)
    assert np.array_equal(a_np.node_min, a_nat.node_min)
    assert np.array_equal(a_np.node_max, a_nat.node_max)
    assert np.array_equal(a_np.node_left, a_nat.node_left)
    assert np.array_equal(a_np.node_right, a_nat.node_right)
    assert np.array_equal(a_np.node_first, a_nat.node_first)
    assert np.array_equal(a_np.node_count, a_nat.node_count)
    assert np.array_equal(a_np.tri_pos, a_nat.tri_pos)
    validate_blas(a_nat, r_nat)


def test_native_degenerate_identical_tris():
    pos = np.tile(
        np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float32),
        (33, 1, 1))
    b = BLASBuilder(backend="native")
    root = b.build_mesh([Surface(positions=pos)])
    arrays = b.finalize()
    validate_blas(arrays, root)


def test_native_multi_mesh_pools():
    rs = np.random.RandomState(7)
    for backend in ("numpy", "native"):
        b = BLASBuilder(backend=backend)
        b.build_mesh([_random_surface(rs, 50)])
    rs = np.random.RandomState(7)
    b_np = BLASBuilder(backend="numpy")
    b_nat = BLASBuilder(backend="native")
    s1 = _random_surface(rs, 60)
    s2 = _random_surface(rs, 90, offset=3.0)
    for b in (b_np, b_nat):
        b.build_mesh([s1])
        b.build_mesh([s2])
    a_np, a_nat = b_np.finalize(), b_nat.finalize()
    assert np.array_equal(a_np.node_min, a_nat.node_min)
    assert np.array_equal(a_np.node_left, a_nat.node_left)
    assert np.array_equal(a_np.tri_pos, a_nat.tri_pos)
    assert b_np.mesh_roots == b_nat.mesh_roots
    assert b_np.mesh_tri_ranges == b_nat.mesh_tri_ranges


def test_native_speed_advantage():
    """The native core should beat NumPy comfortably on a large mesh."""
    import time
    rs = np.random.RandomState(11)
    surf = _random_surface(rs, 20000)
    t0 = time.time()
    BLASBuilder(backend="native").build_mesh([surf])
    t_nat = time.time() - t0
    t0 = time.time()
    BLASBuilder(backend="numpy").build_mesh([surf])
    t_np = time.time() - t0
    assert t_nat < t_np, (t_nat, t_np)
