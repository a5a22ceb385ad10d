"""Failure detection + elastic recovery for multi-chip rendering
(SURVEY.md §5 "Failure detection / elastic recovery").

The reference has nothing here (its only guards are null checks,
path_tracing_camera.cpp:117-121); for a pod-scale renderer the natural
design — noted in SURVEY §5 — is that a frame is STATELESS per (pixel,
frame_index): the RNG is keyed by pixel+frame (core/rng.prng_seed), never
by chip, so any tile can be re-rendered bit-identically by any device.
Recovery is therefore re-dispatch, not checkpoint/rollback:

1. **Detect** — a per-tile health check on the returned AOVs. A dead or
   faulting accelerator surfaces as NaN/Inf radiance, negative depth, or
   an all-zero segments tile (a tile the integrator never traced).
2. **Recover** — re-render exactly the bad tiles (flat pixel-id batches)
   on the healthy default device and scatter the results back into the
   frame. Results are bit-identical to a clean render because per-pixel
   work is deterministic given (pixel, frame).

``render_with_retry`` wraps any frame function; ``inject_tile_fault`` is
the fault-injection hook used by tests (tests/test_fault.py).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from gdpathtracing.config import RenderConfig
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import FrameAOVs
from gdpathtracing.scene.scene import Scene


def tile_health(aovs: FrameAOVs, tile: int = 64) -> np.ndarray:
    """(TH, TW) bool: True where the tile looks healthy. A tile is bad if
    any radiance/depth/normal entry is non-finite, any depth is negative,
    or the whole tile reports zero traced segments (camera rays always
    trace >= 1 segment per pixel).

    Fully vectorized (pad to tile multiples with benign values, reshape,
    reduce): O(1) host ops regardless of tile count — the round-3 Python
    double loop crawled at 4K with small tiles."""
    depth = np.asarray(aovs.depth)
    h, w = depth.shape
    th, tw = -(-h // tile), -(-w // tile)
    ph, pw = th * tile - h, tw * tile - w

    def tiles(x, fill):
        """(h, w[, c]) → (th, tile, tw, tile·c) with benign padding."""
        pad = ((0, ph), (0, pw)) + ((0, 0),) * (x.ndim - 2)
        x = np.pad(x, pad, constant_values=fill)
        return x.reshape(th, tile, tw, -1)

    rad = tiles(np.asarray(aovs.radiance), 0.0)
    nrm = tiles(np.asarray(aovs.normal), 0.0)
    dep = tiles(depth, 0.0)
    segs = tiles(np.asarray(aovs.segments), 0)
    bad = ~np.isfinite(rad).all(axis=(1, 3))
    bad |= ~np.isfinite(nrm).all(axis=(1, 3))
    bad |= (~np.isfinite(dep) | (dep < 0.0)).any(axis=(1, 3))
    # Padding contributes 0 segments; every tile contains >= 1 real pixel.
    bad |= segs.sum(axis=(1, 3), dtype=np.int64) <= 0
    return ~bad


def redundancy_probe(scene: Scene, camera: Camera, config: RenderConfig,
                     frame_index, aovs: FrameAOVs, k: int = 2,
                     tile: int = 64, seed: int = 0,
                     atol: float = 1e-4, frac_bad: float = 0.01
                     ) -> list[tuple[int, int]]:
    """Silent-corruption detector: re-trace `k` randomly chosen tiles with
    the single-device pixel-batch path and compare. `tile_health` only
    catches LOUD failures (NaN/Inf, dropped tiles); a finite-but-wrong
    tile — bit flips, a miscompiled kernel on one chip — passes it. This
    probe makes such corruption detectable in principle at a bounded cost
    (k tiles per frame, ~k·tile²/(H·W) of a full render).

    Comparison is allclose-per-pixel with a mismatching-pixel-fraction
    gate (not bit-equality): the default regen frame loop keeps per-path
    transport identical but may flip traversal tie-breaks on a ~1e-4
    pixel fraction vs the pixel-batch path (CLAUDE.md invariants).
    Returns the list of (ty, tx) tiles whose mismatch exceeds
    `frac_bad` — corrupt with near-certainty."""
    rad = np.asarray(aovs.radiance)
    h, w = rad.shape[:2]
    th, tw = -(-h // tile), -(-w // tile)
    rng = np.random.default_rng(seed)
    n_tiles = th * tw
    picks = rng.choice(n_tiles, size=min(k, n_tiles), replace=False)
    bad: list[tuple[int, int]] = []
    for p in picks:
        ty, tx = int(p) // tw, int(p) % tw
        ys = slice(ty * tile, min((ty + 1) * tile, h))
        xs = slice(tx * tile, min((tx + 1) * tile, w))
        yy, xx = np.mgrid[ys, xs]
        pids = jnp.asarray((yy * w + xx).ravel(), jnp.int32)
        rgb, _, _, _, _ = _render_pixel_batch(
            scene, camera, config, frame_index, pids)
        ref = np.asarray(rgb).reshape(*yy.shape, 3)
        got = rad[ys, xs]
        mism = ~np.isclose(got, ref, atol=atol, rtol=1e-3)
        if not np.isfinite(got).all() or \
                mism.any(axis=-1).mean() > frac_bad:
            bad.append((ty, tx))
    return bad


def _render_pixel_batch(scene: Scene, camera: Camera, config: RenderConfig,
                        frame_index, pids: jnp.ndarray):
    """Re-render a flat batch of pixel ids (the recovery path) using the
    same per-pixel program as the sharded renderer."""
    from gdpathtracing.parallel.sharding import _trace_pixels
    return _trace_pixels(scene, camera, pids, frame_index, config)


def render_with_retry(scene: Scene, camera: Camera, config: RenderConfig,
                      frame_index,
                      render_fn: Callable[..., FrameAOVs],
                      max_retries: int = 2,
                      tile: int = 64,
                      on_retry: Callable[[int, int], None] | None = None,
                      probe_tiles: int = 0
                      ) -> tuple[FrameAOVs, int]:
    """Render a frame and heal unhealthy tiles by re-dispatching exactly
    those pixels. Returns (aovs, tiles_recovered).

    ``render_fn(scene, camera, config, frame_index) -> FrameAOVs`` is the
    primary (possibly sharded) frame path; recovery re-traces bad tiles
    with the single-device pixel-batch path, which is bit-identical
    because the RNG is keyed by (pixel, frame), not by chip.

    ``probe_tiles > 0`` additionally runs the low-rate redundancy probe
    each attempt (silent-corruption detection): probed tiles whose
    radiance disagrees with an independent re-trace beyond tie-break
    noise are healed like loud failures.
    """
    aovs = render_fn(scene, camera, config, frame_index)
    h, w = camera.height, camera.width
    recovered = 0
    for attempt in range(max_retries):
        ok = tile_health(aovs, tile)
        if probe_tiles > 0:
            for ty, tx in redundancy_probe(
                    scene, camera, config, frame_index, aovs,
                    k=probe_tiles, tile=tile,
                    seed=int(np.uint32(frame_index)) + attempt):
                ok[ty, tx] = False
        if ok.all():
            break
        bad = np.argwhere(~ok)
        if on_retry is not None:
            on_retry(attempt, len(bad))
        rad = np.asarray(aovs.radiance).copy()
        depth = np.asarray(aovs.depth).copy()
        steps = np.asarray(aovs.steps).copy()
        segs = np.asarray(aovs.segments).copy()
        normal = np.asarray(aovs.normal).copy()
        for ty, tx in bad:
            ys = slice(ty * tile, min((ty + 1) * tile, h))
            xs = slice(tx * tile, min((tx + 1) * tile, w))
            yy, xx = np.mgrid[ys, xs]
            pids = jnp.asarray((yy * w + xx).ravel(), jnp.int32)
            rgb, d, st, sg, nrm = _render_pixel_batch(
                scene, camera, config, frame_index, pids)
            shape2 = yy.shape
            rad[ys, xs] = np.asarray(rgb).reshape(*shape2, 3)
            depth[ys, xs] = np.asarray(d).reshape(shape2)
            steps[ys, xs] = np.asarray(st).reshape(shape2)
            segs[ys, xs] = np.asarray(sg).reshape(shape2)
            normal[ys, xs] = np.asarray(nrm).reshape(*shape2, 3)
            recovered += 1
        aovs = FrameAOVs(radiance=jnp.asarray(rad),
                         depth=jnp.asarray(depth),
                         steps=jnp.asarray(steps),
                         segments=jnp.asarray(segs),
                         normal=jnp.asarray(normal))
    return aovs, recovered


def inject_tile_fault(aovs: FrameAOVs, ty: int, tx: int,
                      tile: int = 64, kind: str = "nan") -> FrameAOVs:
    """Fault injection for tests: corrupt one tile the way a dying
    accelerator does — NaN radiance ("nan"), a silently-dropped tile
    with zero segments ("drop"), or finite-but-wrong radiance ("silent"
    — passes tile_health; only the redundancy probe can catch it)."""
    rad = np.asarray(aovs.radiance).copy()
    segs = np.asarray(aovs.segments).copy()
    h, w = np.asarray(aovs.depth).shape
    ys = slice(ty * tile, min((ty + 1) * tile, h))
    xs = slice(tx * tile, min((tx + 1) * tile, w))
    if kind == "nan":
        rad[ys, xs] = np.nan
    elif kind == "drop":
        rad[ys, xs] = 0.0
        segs[ys, xs] = 0
    elif kind == "silent":
        rad[ys, xs] = rad[ys, xs] * 0.75 + 0.125
    else:
        raise ValueError(kind)
    return aovs._replace(radiance=jnp.asarray(rad),
                         segments=jnp.asarray(segs))
