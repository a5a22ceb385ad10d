"""Path-regeneration frame loop vs the standard per-bounce integrator.

Each path's RNG stream is keyed by (pixel, sample, frame) and every
per-segment op matches render/integrator.py, so the regenerated frame
must reproduce the standard frame exactly (the PALLAS kernel's winner
does not depend on block composition)."""

from __future__ import annotations

import numpy as np
import pytest

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_demo_scene, demo_camera

W, H = 40, 24


@pytest.fixture(scope="module")
def scene():
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            geometry="sphere")


def _compare(scene, config, camera=None, frame=3):
    camera = camera or demo_camera(W, H)
    ref = render_radiance(scene, camera, config.replace(regen=False), frame)
    got = render_radiance(scene, camera, config.replace(regen=True), frame)
    np.testing.assert_allclose(np.asarray(got.radiance),
                               np.asarray(ref.radiance), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.depth),
                               np.asarray(ref.depth), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.segments),
                                  np.asarray(ref.segments))
    np.testing.assert_allclose(np.asarray(got.normal),
                               np.asarray(ref.normal), atol=1e-6)


def test_regen_matches_brute(scene):
    _compare(scene, RenderConfig(bounces=4, traversal=Traversal.BRUTE))


def test_regen_small_wavefront(scene):
    # Wavefront much smaller than the path pool: many regeneration rounds.
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.BRUTE,
                                 tile_rays=256, regen_wavefront=256))


def test_regen_nee(scene):
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.BRUTE,
                                 nee=True))


def test_regen_spp(scene):
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.BRUTE,
                                 spp=2, tile_rays=512, regen_wavefront=512))


def test_regen_rr(scene):
    _compare(scene, RenderConfig(bounces=5, traversal=Traversal.BRUTE,
                                 rr_start=2))


def test_regen_pallas_interpret(scene):
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                                 tile_rays=1024, regen_wavefront=1024))


def test_regen_nee_pallas(scene):
    # PALLAS + NEE: the regen loop resolves each shadow ray with the
    # any-hit kernel in the same iteration, as the standard loop does.
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                                 nee=True, tile_rays=1024,
                                 regen_wavefront=1024))


def test_regen_superchunk_pallas():
    """A scene of several superchunks (the kernel's two-level loop and
    per-block queue) through regen must reproduce the standard frame.
    On this scene XLA contracts the unit-space dot products of the two
    programs differently (UNIT shows the same few-ulp depth differences),
    so radiance is compared at 1e-4; the traced segments must agree."""
    from gdpathtracing.scene.demo import build_sphere_grid, grid_camera
    gscene = build_sphere_grid(n=4)
    cam = grid_camera(40, 24, n=4)
    cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                       regen_wavefront=512)
    ref = render_radiance(gscene, cam, cfg.replace(regen=False), 3)
    got = render_radiance(gscene, cam, cfg.replace(regen=True), 3)
    np.testing.assert_allclose(np.asarray(got.radiance),
                               np.asarray(ref.radiance), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.segments),
                                  np.asarray(ref.segments))


def test_regen_no_lane_compaction(scene):
    # compact_rays=False disables the survivors-first lane permutation;
    # transport must be identical either way.
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.BRUTE,
                                 compact_rays=False, tile_rays=512, regen_wavefront=512))


def test_regen_sorted_lanes(scene):
    # sort_rays=True switches the lane permutation to the Morton+octant
    # key (the superchunk-scene mode); transport must be unchanged.
    _compare(scene, RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                                 sort_rays=True, tile_rays=1024,
                                 regen_wavefront=1024))


def test_regen_steps_total(scene):
    # steps is a per-path traversal-cost AOV: totals must match exactly on
    # the brute backend (it reports a fixed per-trace count).
    config = RenderConfig(bounces=3, traversal=Traversal.BRUTE)
    camera = demo_camera(W, H)
    ref = render_radiance(scene, camera, config.replace(regen=False), 1)
    got = render_radiance(scene, camera, config.replace(regen=True), 1)
    assert int(np.asarray(got.steps).sum()) == int(
        np.asarray(ref.steps).sum())


def test_regen_log_retirement_bit_matches_scatter(scene):
    """The contiguous retirement log (the default) must produce
    BIT-identical AOVs to the column-scatter retirement in every mode
    combination — the log only changes where retired values are written,
    never the values (pids ride the f32 log as exact value casts, not
    bitcasts, so no denormal can be flushed)."""
    from gdpathtracing.render.regen import render_radiance_regen
    cam = demo_camera(W, H)
    for nee, sort in ((False, True), (True, True), (True, False)):
        cfg = RenderConfig(bounces=3, traversal=Traversal.PALLAS,
                           nee=nee, sort_rays=sort, regen=True,
                           regen_wavefront=512)
        aL = render_radiance_regen(
            scene, cam, cfg.replace(regen_retire="log"), 3)
        aS = render_radiance_regen(
            scene, cam, cfg.replace(regen_retire="scatter"), 3)
        for k in ("radiance", "depth", "segments", "steps", "normal"):
            np.testing.assert_array_equal(
                np.asarray(getattr(aL, k)), np.asarray(getattr(aS, k)),
                err_msg=f"nee={nee} sort={sort} aov={k}")


def test_regen_two_phase_drain(scene):
    """Two-phase drain: handing the sorted live prefix to a
    smaller second while_loop must not change any AOV (same bodies,
    same RNG streams, only the lane-buffer size differs)."""
    cam = demo_camera(W, H)
    for nee in (False, True):
        cfg = RenderConfig(bounces=3, traversal=Traversal.BRUTE, nee=nee,
                           regen=True, regen_wavefront=512)
        a = render_radiance(scene, cam,
                            cfg.replace(regen_drain=True,
                                        regen_drain_wavefront=256), 3)
        b = render_radiance(scene, cam, cfg.replace(regen_drain=False), 3)
        for k in ("radiance", "depth", "segments", "steps", "normal"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, k)), np.asarray(getattr(b, k)),
                err_msg=f"nee={nee} aov={k}")
