"""Dynamic scene updates: moved instances / deformed vertices must trace
identically to a scene rebuilt from scratch."""

import numpy as np
import jax
import jax.numpy as jnp

from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.intersect import trace_brute, trace_unit
from gdpathtracing.render.traverse import trace_bvh
from gdpathtracing.render.types import Ray
from gdpathtracing.scene.demo import build_demo_scene
from gdpathtracing.scene.dynamic import (refit_blas,
                                             update_instance_transforms,
                                             update_vertices)


def _rays(n, seed=0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    o[: n // 2] = np.array([0, 0, 9.7694], np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))


def _assert_hits_match(a, b, tol=1e-4):
    at, bt = np.asarray(a.t), np.asarray(b.t)
    ha, hb = at < 1e8, bt < 1e8
    assert (ha == hb).mean() > 0.995, np.sum(ha != hb)
    both = ha & hb
    assert np.allclose(at[both], bt[both], rtol=tol, atol=tol)
    clear = both & (np.abs(at - bt) < 1e-5)
    assert (np.asarray(a.inst)[clear] == np.asarray(b.inst)[clear]).mean() > 0.999


def test_update_instance_transforms_matches_rebuild():
    scene = build_demo_scene(texture_resolution=4, sphere_detail=6, geometry="sphere")
    tfs = np.asarray(scene.inst_transform).copy()
    tfs[2, :, 3] += [0.5, 0.3, -0.4]   # move one sphere
    tfs[3, :, :3] *= 0.8               # shrink the other

    moved = jax.jit(update_instance_transforms)(scene, jnp.asarray(tfs))

    ray = _rays(256)
    # unit-space tables must agree with a brute trace through the SAME
    # moved scene's per-instance path (object-space transforms)
    _assert_hits_match(trace_unit(moved, ray), trace_brute(moved, ray))
    # TLAS refit must keep the two-level traversal consistent too
    _assert_hits_match(trace_bvh(moved, ray), trace_brute(moved, ray))


def test_update_instances_changes_hits():
    scene = build_demo_scene(texture_resolution=4, sphere_detail=6, geometry="sphere")
    tfs = np.asarray(scene.inst_transform).copy()
    tfs[2, :, 3] += [2.0, 0.0, 0.0]
    moved = update_instance_transforms(scene, jnp.asarray(tfs))
    ray = _rays(256, seed=2)
    before = np.asarray(trace_unit(scene, ray).t)
    after = np.asarray(trace_unit(moved, ray).t)
    assert not np.allclose(before, after)


def test_refit_blas_and_vertices():
    scene = build_demo_scene(texture_resolution=4, sphere_detail=6, geometry="sphere")
    new_pos = scene.tri_pos * 1.1  # inflate all meshes about origin
    deformed = jax.jit(update_vertices)(scene, new_pos)
    # BLAS bounds contain the new triangles
    nmin = np.asarray(deformed.node_min)
    nmax = np.asarray(deformed.node_max)
    tmin = np.asarray(new_pos.min(axis=1))
    tmax = np.asarray(new_pos.max(axis=1))
    first = np.asarray(deformed.node_first)
    count = np.asarray(deformed.node_count)
    for i in np.nonzero(count > 0)[0][:50]:
        sl = slice(first[i], first[i] + count[i])
        assert (tmin[sl] >= nmin[i] - 1e-4).all()
        assert (tmax[sl] <= nmax[i] + 1e-4).all()
    # and traversal agrees with brute on the deformed scene
    ray = _rays(128, seed=3)
    _assert_hits_match(trace_bvh(deformed, ray), trace_brute(deformed, ray))
    _assert_hits_match(trace_unit(deformed, ray), trace_brute(deformed, ray))
