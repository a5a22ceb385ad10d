"""Failure detection + elastic recovery (SURVEY.md §5): a frame is
stateless per (pixel, frame) — RNG keyed by pixel+frame, never chip — so
recovery = re-dispatch of exactly the unhealthy tiles, bit-identical to a
clean render."""

import jax.numpy as jnp
import numpy as np
import pytest

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.parallel.fault import (inject_tile_fault,
                                              redundancy_probe,
                                              render_with_retry,
                                              tile_health)
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_demo_scene, demo_camera

TILE = 16


@pytest.fixture(scope="module")
def setup():
    scene = build_demo_scene(texture_resolution=4, sphere_detail=6,
                             geometry="sphere")
    cam = demo_camera(48, 32)
    cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.UNIT,
                       jitter=Jitter.NONE)
    return scene, cam, cfg


def test_healthy_frame_passes_and_skips_recovery(setup):
    scene, cam, cfg = setup
    clean = render_radiance(scene, cam, cfg, 0)
    assert tile_health(clean, TILE).all()
    aovs, recovered = render_with_retry(
        scene, cam, cfg, 0, render_radiance, tile=TILE)
    assert recovered == 0
    np.testing.assert_array_equal(np.asarray(aovs.radiance),
                                  np.asarray(clean.radiance))


@pytest.mark.parametrize("kind", ["nan", "drop"])
def test_injected_fault_detected_and_healed_bit_identically(setup, kind):
    scene, cam, cfg = setup
    clean = render_radiance(scene, cam, cfg, 5)

    calls = {"n": 0}

    def faulty_render(scene, cam, cfg, f):
        calls["n"] += 1
        return inject_tile_fault(render_radiance(scene, cam, cfg, f),
                                 1, 2, TILE, kind)

    faulty = faulty_render(scene, cam, cfg, 5)
    ok = tile_health(faulty, TILE)
    assert not ok[1, 2] and ok.sum() == ok.size - 1

    retries = []
    aovs, recovered = render_with_retry(
        scene, cam, cfg, 5, faulty_render, tile=TILE,
        on_retry=lambda a, n: retries.append((a, n)))
    assert recovered == 1
    assert retries == [(0, 1)]
    # Healed frame is BIT-identical to the clean render: per-pixel work is
    # deterministic given (pixel, frame), so re-dispatch reproduces it.
    np.testing.assert_array_equal(np.asarray(aovs.radiance),
                                  np.asarray(clean.radiance))
    np.testing.assert_array_equal(np.asarray(aovs.depth),
                                  np.asarray(clean.depth))
    np.testing.assert_array_equal(np.asarray(aovs.segments),
                                  np.asarray(clean.segments))


def test_silent_corruption_caught_by_redundancy_probe(setup):
    """A finite-but-wrong tile passes tile_health (by design — it only
    catches loud failures) but the redundancy probe flags it, and
    render_with_retry(probe_tiles=...) heals it bit-identically."""
    scene, cam, cfg = setup
    clean = render_radiance(scene, cam, cfg, 7)
    corrupted = inject_tile_fault(clean, 1, 1, TILE, "silent")
    assert tile_health(corrupted, TILE).all()  # loud check is blind to it

    # Probe every tile (k >= n_tiles): exactly the corrupted one flags;
    # the clean frame flags none (tie-break tolerance, no false alarms).
    assert redundancy_probe(scene, cam, cfg, 7, corrupted, k=6,
                            tile=TILE) == [(1, 1)]
    assert redundancy_probe(scene, cam, cfg, 7, clean, k=6,
                            tile=TILE) == []

    def faulty_render(scene, cam, cfg, f):
        return inject_tile_fault(render_radiance(scene, cam, cfg, f),
                                 1, 1, TILE, "silent")

    aovs, recovered = render_with_retry(
        scene, cam, cfg, 7, faulty_render, tile=TILE, probe_tiles=6)
    assert recovered == 1
    np.testing.assert_array_equal(np.asarray(aovs.radiance),
                                  np.asarray(clean.radiance))


def test_persistent_fault_bounded_by_max_retries(setup):
    scene, cam, cfg = setup

    def always_faulty(scene, cam, cfg, f):
        return inject_tile_fault(render_radiance(scene, cam, cfg, f),
                                 0, 0, TILE, "nan")

    # Recovery re-traces the tile; the primary render stays faulty only in
    # the render_fn output, so one retry heals it — but a recovery path
    # that itself kept failing must terminate: max_retries bounds the loop.
    aovs, recovered = render_with_retry(
        scene, cam, cfg, 1, always_faulty, max_retries=2, tile=TILE)
    assert recovered == 1
    assert tile_health(aovs, TILE).all()
