"""Möller–Trumbore + slab AABB unit tests, and brute-force oracle vs BVH
traversal equivalence on random rays (SURVEY.md §4c)."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.intersect import (intersect_aabb,
                                                moller_trumbore, trace_brute)
from gdpathtracing.render.traverse import trace_bvh
from gdpathtracing.render.types import Ray
from gdpathtracing.scene.demo import build_demo_scene


def _ray(o, d):
    o = np.asarray(o, np.float32)[None]
    d = np.asarray(d, np.float32)[None]
    return Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))


def _tri(v0, v1, v2):
    return tuple(
        Vec3.from_array(jnp.asarray(np.asarray(v, np.float32)[None]))
        for v in (v0, v1, v2))


def test_mt_hit_and_barycentrics():
    v0, v1, v2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
    ray = _ray([0.25, 0.25, 1.0], [0, 0, -1])
    ok, t, u, v, front = moller_trumbore(ray, v0, v1, v2, jnp.float32(1e9))
    assert bool(ok[0])
    assert abs(float(t[0]) - 1.0) < 1e-6
    assert abs(float(u[0]) - 0.25) < 1e-6
    assert abs(float(v[0]) - 0.25) < 1e-6
    # geometric normal +z faces the ray coming from +z → front
    assert bool(front[0])


def test_mt_miss_outside():
    v0, v1, v2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
    ok, *_ = moller_trumbore(_ray([0.9, 0.9, 1.0], [0, 0, -1]),
                             v0, v1, v2, jnp.float32(1e9))
    assert not bool(ok[0])


def test_mt_no_backface_cull():
    v0, v1, v2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
    ok, t, u, v, front = moller_trumbore(_ray([0.2, 0.2, -1.0], [0, 0, 1]),
                                         v0, v1, v2, jnp.float32(1e9))
    assert bool(ok[0])  # abs(det): both sides hit (main.glsl:237)
    assert not bool(front[0])


def test_mt_behind_origin():
    v0, v1, v2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
    ok, *_ = moller_trumbore(_ray([0.2, 0.2, -1.0], [0, 0, -1]),
                             v0, v1, v2, jnp.float32(1e9))
    assert not bool(ok[0])


def test_aabb_slab():
    o = Vec3.from_array(jnp.asarray([[0.0, 0.0, -5.0]], dtype=jnp.float32))
    d = Vec3.from_array(jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32))
    rcp = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    bmin = Vec3.from_array(jnp.asarray([[-1.0, -1.0, -1.0]], dtype=jnp.float32))
    bmax = Vec3.from_array(jnp.asarray([[1.0, 1.0, 1.0]], dtype=jnp.float32))
    t = intersect_aabb(o, rcp, bmin, bmax)
    assert abs(float(t[0]) - 4.0) < 1e-6
    # From inside: tmin < 0 but tmax > 0 → returns tmin (negative), a hit.
    o2 = Vec3.from_array(jnp.asarray([[0.0, 0.0, 0.0]], dtype=jnp.float32))
    t2 = intersect_aabb(o2, rcp, bmin, bmax)
    assert float(t2[0]) < 0.0
    # Miss
    o3 = Vec3.from_array(jnp.asarray([[5.0, 5.0, -5.0]], dtype=jnp.float32))
    t3 = intersect_aabb(o3, rcp, bmin, bmax)
    assert float(t3[0]) >= 1e29


def _random_rays(n, seed=0):
    rs = np.random.RandomState(seed)
    # Mix of rays from outside-looking-in and inside the demo scene.
    o = rs.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    o[: n // 2] = np.array([0, 0, 9.7694], np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))


def test_bvh_matches_brute_oracle():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    ray = _random_rays(512)
    brute = trace_brute(scene, ray)
    bvh = trace_bvh(scene, ray)
    bt = np.asarray(brute.t)
    vt = np.asarray(bvh.t)
    hit_b = bt < 1e8
    hit_v = vt < 1e8
    assert (hit_b == hit_v).all(), f"hit mismatch: {np.sum(hit_b != hit_v)}"
    assert np.allclose(bt[hit_b], vt[hit_b], rtol=1e-4, atol=1e-4)
    # Same triangle except possible t-ties; compare instance+tri on clear hits
    clear = hit_b & (np.abs(bt - vt) < 1e-5)
    assert (np.asarray(brute.inst)[clear] == np.asarray(bvh.inst)[clear]).mean() > 0.999
    assert (np.asarray(brute.tri)[clear] == np.asarray(bvh.tri)[clear]).mean() > 0.999


def test_bvh_active_mask():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=4, geometry="sphere")
    ray = _random_rays(64, seed=1)
    active = jnp.zeros(64, dtype=bool)
    hit = trace_bvh(scene, ray, active=active)
    assert (np.asarray(hit.t) >= 1e8).all()


def test_unit_matches_brute_oracle():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    ray = _random_rays(512, seed=3)
    from gdpathtracing.render.intersect import trace_unit
    brute = trace_brute(scene, ray)
    unit = trace_unit(scene, ray)
    bt, ut = np.asarray(brute.t), np.asarray(unit.t)
    hit_b, hit_u = bt < 1e8, ut < 1e8
    agree = hit_b == hit_u
    assert agree.mean() > 0.998, f"hit mismatch {np.sum(~agree)}"
    both = hit_b & hit_u
    assert np.allclose(bt[both], ut[both], rtol=1e-3, atol=1e-3)
    clear = both & (np.abs(bt - ut) < 1e-4)
    assert (np.asarray(brute.inst)[clear] == np.asarray(unit.inst)[clear]).mean() > 0.999
    assert (np.asarray(brute.tri)[clear] == np.asarray(unit.tri)[clear]).mean() > 0.999
    # barycentrics and front flags agree on clear hits
    assert np.allclose(np.asarray(brute.u)[clear], np.asarray(unit.u)[clear],
                       atol=2e-3)
    assert (np.asarray(brute.front)[clear] == np.asarray(unit.front)[clear]).mean() > 0.999


def test_pallas_interpret_matches_brute_oracle():
    from gdpathtracing.ops.intersect_pallas import trace_pallas
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    ray = _random_rays(300, seed=5)
    brute = trace_brute(scene, ray)
    pal = trace_pallas(scene, ray)
    bt, pt = np.asarray(brute.t), np.asarray(pal.t)
    assert ((bt < 1e8) == (pt < 1e8)).mean() > 0.998
    both = (bt < 1e8) & (pt < 1e8)
    assert np.allclose(bt[both], pt[both], rtol=1e-3, atol=1e-3)
    clear = both & (np.abs(bt - pt) < 1e-4)
    assert (np.asarray(brute.tri)[clear] == np.asarray(pal.tri)[clear]).mean() > 0.999
    assert np.allclose(np.asarray(brute.u)[clear], np.asarray(pal.u)[clear],
                       atol=2e-3)
    assert (np.asarray(brute.front)[clear] == np.asarray(pal.front)[clear]).mean() > 0.999


def test_pallas_superchunk_matches_brute_oracle():
    """The two-level loop over several superchunks must agree with the
    brute-force oracle, including across superchunk boundaries."""
    from gdpathtracing.ops.intersect_pallas import (prepare_trace_inputs,
                                                    trace_pallas)
    from gdpathtracing.scene.demo import build_sphere_grid
    scene = build_sphere_grid(n=4, sphere_detail=12)
    prep = prepare_trace_inputs(scene)
    assert prep.sb.shape[1] > 1, prep.sb.shape  # several superchunks
    ray = _random_rays(300, seed=11)
    brute = trace_brute(scene, ray)
    pal = trace_pallas(scene, ray, prep=prep)
    bt, pt = np.asarray(brute.t), np.asarray(pal.t)
    assert ((bt < 1e8) == (pt < 1e8)).mean() > 0.998
    both = (bt < 1e8) & (pt < 1e8)
    assert np.allclose(bt[both], pt[both], rtol=1e-3, atol=1e-3)
    clear = both & (np.abs(bt - pt) < 1e-4)
    assert (np.asarray(brute.tri)[clear]
            == np.asarray(pal.tri)[clear]).mean() > 0.999
    assert np.allclose(np.asarray(brute.u)[clear], np.asarray(pal.u)[clear],
                       atol=2e-3)


def test_octant_sort_is_transparent():
    """Ray sorting must be invisible: per-ray math is order-independent,
    so a sorted render bit-matches the unsorted one after the final
    unsort scatter."""
    from gdpathtracing.config import Jitter, RenderConfig, Traversal
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import build_sphere_grid, grid_camera
    scene = build_sphere_grid(n=4, sphere_detail=12)
    assert scene.isect_mu.shape[1] > 16 * 256  # several superchunks
    cam = grid_camera(16, 12, n=4)
    base = dict(bounces=2, spp=1, jitter=Jitter.NONE,
                traversal=Traversal.PALLAS)
    a = render_radiance(scene, cam,
                        RenderConfig(sort_rays=True, **base), 0)
    b = render_radiance(scene, cam,
                        RenderConfig(sort_rays=False, **base), 0)
    np.testing.assert_array_equal(np.asarray(a.radiance),
                                  np.asarray(b.radiance))
    np.testing.assert_array_equal(np.asarray(a.depth), np.asarray(b.depth))
    np.testing.assert_array_equal(np.asarray(a.segments),
                                  np.asarray(b.segments))


def test_wavefront_compaction_is_transparent():
    """Survivor compaction on the wavefront-PALLAS path (config.compact_rays
    with sort_rays off — stable cumsum partition by `active`) must be
    invisible in the per-ray results:
    radiance/depth/segments bit-match the uncompacted render after the
    final unsort scatter. (steps may differ: block composition changes
    which chunks a block collectively sweeps.)"""
    from gdpathtracing.config import Jitter, RenderConfig, Traversal
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import build_sphere_grid, grid_camera
    scene = build_sphere_grid(n=4, sphere_detail=12)
    cam = grid_camera(48, 32, n=4)  # several blocks → real tail parking
    base = dict(bounces=3, spp=1, jitter=Jitter.NONE,
                traversal=Traversal.PALLAS, sort_rays=False)
    a = render_radiance(scene, cam,
                        RenderConfig(compact_rays=True, **base), 0)
    b = render_radiance(scene, cam,
                        RenderConfig(compact_rays=False, **base), 0)
    np.testing.assert_array_equal(np.asarray(a.radiance),
                                  np.asarray(b.radiance))
    np.testing.assert_array_equal(np.asarray(a.depth), np.asarray(b.depth))
    np.testing.assert_array_equal(np.asarray(a.segments),
                                  np.asarray(b.segments))


def test_pallas_render_matches_unit_end_to_end():
    """End-to-end guard on the kernel epilogue (eidx → tri/inst/u/v/front,
    the NEE pdf by eidx): a full PALLAS render must match the UNIT render,
    with and without NEE. The per-hit oracle tests only check
    t/tri/u/v/front; a wrong eidx mapping would pass them."""
    from gdpathtracing.config import Jitter, RenderConfig, Traversal
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    cam = demo_camera(24, 16)
    for nee in (False, True):
        base = dict(bounces=3, spp=1, jitter=Jitter.NONE, nee=nee)
        pal = render_radiance(scene, cam, RenderConfig(
            traversal=Traversal.PALLAS, **base), 0)
        unit = render_radiance(scene, cam, RenderConfig(
            traversal=Traversal.UNIT, **base), 0)
        assert np.allclose(np.asarray(pal.radiance),
                           np.asarray(unit.radiance),
                           rtol=1e-5, atol=1e-5), f"nee={nee}"
        np.testing.assert_array_equal(np.asarray(pal.segments),
                                      np.asarray(unit.segments))


def test_pallas_steps_aov_has_structure():
    """The kernel's steps output counts triangles actually swept per ray
    (chunks whose slab test passed × CHUNK) — the DEBUG_STEPS heatmap
    analog (main.glsl:358-361). It must be bounded by the full sweep and
    show per-ray structure, not the constant E."""
    import gdpathtracing.ops.intersect_pallas as ip
    scene = build_demo_scene(texture_resolution=8, sphere_detail=16, geometry="sphere")
    e = scene.isect_mu.shape[1]
    assert e // ip.CHUNK >= 4  # needs several chunks for structure
    ray = _random_rays(512, seed=7)
    pal = ip.trace_pallas(scene, ray)
    steps = np.asarray(pal.steps)
    assert (steps >= 0).all() and (steps <= e).all()
    assert steps.min() < steps.max()  # not a constant
    hit = np.asarray(pal.t) < 1e8
    assert (steps[hit] >= ip.CHUNK).all()  # a hit costs at least its chunk


def test_fast_shading_matches_classic():
    """Packed-row shading (eidx path) must reproduce the classic
    multi-gather shading exactly on unit-backend hits."""
    from gdpathtracing.render.intersect import trace_unit
    from gdpathtracing.render.shading import (get_shading_data,
                                                  get_shading_data_fast)
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    ray = _random_rays(256, seed=9)
    hit = trace_unit(scene, ray)
    classic = get_shading_data(scene, hit, ray)
    fast = get_shading_data_fast(scene, hit, ray)
    m = np.asarray(hit.t) < 1e8
    for name in ("position", "normal", "out_dir", "emission",
                 "diffuse_albedo", "fresnel_0"):
        a = np.asarray(getattr(classic, name).to_array())[m]
        b = np.asarray(getattr(fast, name).to_array())[m]
        assert np.allclose(a, b, rtol=1e-4, atol=1e-5), name
    assert np.allclose(np.asarray(classic.roughness)[m],
                       np.asarray(fast.roughness)[m])
    assert np.allclose(np.asarray(classic.lambert_out)[m],
                       np.asarray(fast.lambert_out)[m], atol=1e-5)
