"""End-to-end integrator tests on the Cornell scenes (BASELINE config 1/3):
non-trivial image, wall color bleeding, brute/BVH agreement, depth AOV."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import (build_cornell_simple,
                                          build_demo_scene, demo_camera)

RES = 64


def _render(scene, bounces=2, spp=4, traversal=Traversal.BRUTE, frame=0,
            res=RES):
    cam = demo_camera(res, res)
    cfg = RenderConfig(bounces=bounces, spp=spp, traversal=traversal,
                       jitter=Jitter.UNIFORM)
    return render_radiance(scene, cam, cfg, frame)


def test_cornell_renders_sensible_image():
    scene = build_cornell_simple()
    aovs = _render(scene, bounces=3, spp=4)
    img = np.asarray(aovs.radiance)
    assert img.shape == (RES, RES, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # lit
    # The emissive plane (energy 10) projects to rows ≈ 19-22, cols 28-36
    # at this fov/camera; the floor to rows ≈ 44-50. Light ≫ floor.
    light = img[int(RES * 0.30):int(RES * 0.345),
                int(RES * 0.44):int(RES * 0.56)].mean()
    floor = img[int(RES * 0.69):int(RES * 0.78),
                int(RES * 0.38):int(RES * 0.62)].mean()
    assert light > 2.0 * floor, (light, floor)
    assert light > 5.0  # direct emission ~10


def test_cornell_wall_colors():
    scene = build_cornell_simple()
    aovs = _render(scene, bounces=2, spp=8, traversal=Traversal.BRUTE)
    img = np.asarray(aovs.radiance)
    # With fov 79.5 at z=9.7694, the box (±3) fills only the central ~54%
    # of the frame; the side walls project to |sx| in ~[0.28, 0.53].
    c = RES // 2
    lo, hi = int(c * 1.32), int(c * 1.48)
    rows = slice(c - RES // 8, c + RES // 8)
    right = img[rows, lo:hi]
    left = img[rows, RES - hi:RES - lo]
    # demo.tscn: red wall right, green wall left (after the box's 90° Y
    # rotation — see SURVEY demo analysis).
    assert right[..., 0].mean() > 1.5 * right[..., 1].mean(), "right not red"
    assert left[..., 1].mean() > 1.5 * left[..., 0].mean(), "left not green"


def test_brute_and_bvh_render_identically():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    a = _render(scene, bounces=2, spp=2, traversal=Traversal.BRUTE, res=32)
    b = _render(scene, bounces=2, spp=2, traversal=Traversal.BVH, res=32)
    ia, ib = np.asarray(a.radiance), np.asarray(b.radiance)
    # Same RNG streams + same hits → images match almost exactly.
    assert np.allclose(ia, ib, rtol=1e-3, atol=1e-3), \
        np.abs(ia - ib).max()


def test_depth_aov():
    scene = build_cornell_simple()
    aovs = _render(scene, bounces=1, spp=1)
    depth = np.asarray(aovs.depth)
    center = depth[RES // 2, RES // 2]
    # Camera at z=9.7694, back wall at z=-3 → about 12.8 away.
    assert 11.0 < center < 14.0, center
    assert np.isfinite(depth).all()


def test_deterministic_given_frame_index():
    scene = build_cornell_simple()
    a = _render(scene, spp=1, frame=5)
    b = _render(scene, spp=1, frame=5)
    assert np.array_equal(np.asarray(a.radiance), np.asarray(b.radiance))
    c = _render(scene, spp=1, frame=6)
    assert not np.array_equal(np.asarray(a.radiance), np.asarray(c.radiance))


def test_emissive_sphere_glows():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6, geometry="sphere")
    aovs = _render(scene, bounces=2, spp=4, res=48)
    img = np.asarray(aovs.radiance)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_russian_roulette_unbiased_and_shorter():
    """rr_start > 0: expected radiance unchanged
    (statistically), expected path length strictly shorter. Throughput-
    proportional survival from bounce rr_start on, 1/p compensation."""
    scene = build_cornell_simple()
    cam = demo_camera(24, 24)
    base = RenderConfig(bounces=5, spp=32, traversal=Traversal.BRUTE,
                        jitter=Jitter.UNIFORM)
    rr = base.replace(rr_start=2)
    a = render_radiance(scene, cam, base, frame_index=0)
    b = render_radiance(scene, cam, rr, frame_index=0)
    seg_a = int(np.asarray(a.segments, np.int64).sum())
    seg_b = int(np.asarray(b.segments, np.int64).sum())
    assert seg_b < seg_a, (seg_b, seg_a)  # roulette shortens paths
    # Unbiasedness: image means agree to a few percent at this spp count
    # (Cornell albedos ≤ 0.8 → survival p is high; variance added is mild).
    ma = float(np.asarray(a.radiance).mean())
    mb = float(np.asarray(b.radiance).mean())
    assert abs(ma - mb) / ma < 0.05, (ma, mb)
    assert np.isfinite(np.asarray(b.radiance)).all()


def test_russian_roulette_off_is_bit_identical():
    """rr_start=0 must not perturb the RNG stream (golden safety)."""
    scene = build_cornell_simple()
    cam = demo_camera(16, 16)
    cfg = RenderConfig(bounces=3, spp=2, traversal=Traversal.BRUTE)
    a = render_radiance(scene, cam, cfg, 0)
    b = render_radiance(scene, cam, cfg.replace(rr_start=0), 0)
    assert np.array_equal(np.asarray(a.radiance), np.asarray(b.radiance))
