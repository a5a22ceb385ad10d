"""Top-level render functions — the analog of PathTracingCamera::render()
(src/path_tracing/path_tracing_camera.cpp:193-232), minus its
GPU↔CPU round trip (the reference reads the image back and re-uploads it
every frame, cpp:228-230 — here everything stays on device).

``render_radiance`` traces one frame (radiance + depth AOV);
``render_frame`` adds the denoising/post stage and returns a tonemapped
image plus the functional post state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdpathtracing.config import DenoisingMode, RenderConfig
from gdpathtracing.core import rng
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.integrator import get_trace_fn, path_trace
from gdpathtracing.post.progressive import (ProgressiveState,
                                                progressive_init,
                                                progressive_update)
from gdpathtracing.post.temporal import (TemporalState, nonlinear_depth,
                                             temporal_init, temporal_update)
from gdpathtracing.post.tonemap import aces_film
from gdpathtracing.scene.scene import Scene


class FrameAOVs(NamedTuple):
    radiance: jnp.ndarray  # (H, W, 3) f32 linear
    depth: jnp.ndarray     # (H, W) f32 linear first-hit distance
    steps: jnp.ndarray     # (H, W) i32 triangle tests (DEBUG_STEPS analog)
    segments: jnp.ndarray  # (H, W) i32 traced ray segments (for Mrays/s)
    normal: jnp.ndarray    # (H, W, 3) f32 first-hit normal (0 on miss)


def render_radiance(scene: Scene, camera: Camera, config: RenderConfig,
                    frame_index=0) -> FrameAOVs:
    """Trace the full frame. Rays are traced in tiles of
    ``config.tile_rays`` (bounds the live wavefront + stack memory — the
    analog of the 32×32 workgroup tiling at main.glsl:404)."""
    if config.regen is not False:
        from gdpathtracing.render.regen import (regen_auto,
                                                    regen_supported,
                                                    render_radiance_regen)
        if config.regen:
            if not regen_supported(scene, config):
                raise ValueError("config.regen requires a primal "
                                 "BRUTE/UNIT/PALLAS render (no soft "
                                 "shadows/soft primary)")
            return render_radiance_regen(scene, camera, config,
                                         frame_index)
        if regen_auto(scene, config):  # None = auto (large scenes)
            return render_radiance_regen(scene, camera, config,
                                         frame_index)
    w, h = camera.width, camera.height
    n_pix = w * h
    tile = min(config.tile_rays, n_pix)
    n_tiles = -(-n_pix // tile)
    padded = n_tiles * tile

    if config.differentiable and config.bwd_checkpoint is None:
        # Resolve the shape-aware checkpoint rule at FRAME scope: the
        # tile loop below is a lax.map (a scan), so under autodiff the
        # no-checkpoint residuals accumulate across ALL tiles and spp
        # samples — the per-call wavefront the integrator sees would
        # underestimate them by n_tiles x spp.
        resid = (padded * config.spp * config.bounces
                 * config.bwd_resid_bytes_per_seg)
        config = config.replace(
            bwd_checkpoint=resid > config.bwd_resid_budget)

    pixel_ids = jnp.arange(padded, dtype=jnp.int32) % n_pix
    tiles = pixel_ids.reshape(n_tiles, tile)
    trace_fn = get_trace_fn(config, scene)
    frame_index = jnp.asarray(frame_index, dtype=jnp.uint32)

    def do_tile(pids):
        px = (pids % w).astype(jnp.uint32)
        py = (pids // w).astype(jnp.uint32)
        acc_r = jnp.zeros(tile, jnp.float32)
        acc_g = jnp.zeros(tile, jnp.float32)
        acc_b = jnp.zeros(tile, jnp.float32)
        depth = None
        steps = jnp.zeros(tile, jnp.int32)
        segments = jnp.zeros(tile, jnp.int32)
        normal = None
        for s in range(config.spp):  # static unroll; spp is per-frame small
            seed = rng.prng_seed(px, py,
                                 frame_index * jnp.uint32(config.spp)
                                 + jnp.uint32(s))
            ray, seed = camera.generate_rays(pids, seed, config)
            res = path_trace(scene, ray, seed, config, trace_fn,
                             far=camera.far)
            acc_r = acc_r + res.radiance.x
            acc_g = acc_g + res.radiance.y
            acc_b = acc_b + res.radiance.z
            depth = res.depth if depth is None else jnp.minimum(depth,
                                                                res.depth)
            steps = steps + res.steps
            segments = segments + res.segments
            if normal is None:
                normal = res.normal.to_array()
        inv = 1.0 / config.spp
        return (jnp.stack([acc_r * inv, acc_g * inv, acc_b * inv], axis=-1),
                depth, steps, segments, normal)

    if n_tiles == 1:
        rgb, depth, steps, segments, normal = do_tile(tiles[0])
    else:
        rgb, depth, steps, segments, normal = jax.lax.map(do_tile, tiles)
        rgb = rgb.reshape(padded, 3)

    rgb = rgb.reshape(-1, 3)[:n_pix].reshape(h, w, 3)
    depth = depth.reshape(-1)[:n_pix].reshape(h, w)
    steps = steps.reshape(-1)[:n_pix].reshape(h, w)
    segments = segments.reshape(-1)[:n_pix].reshape(h, w)
    normal = normal.reshape(-1, 3)[:n_pix].reshape(h, w, 3)
    return FrameAOVs(radiance=rgb, depth=depth, steps=steps,
                     segments=segments, normal=normal)


def render(scene: Scene, camera: Camera, config: RenderConfig | None = None,
           frame_index=0) -> jnp.ndarray:
    """One-shot convenience: trace + ACES tonemap → (H, W, 3) in [0, 1]."""
    config = config or RenderConfig()
    aovs = render_radiance(scene, camera, config, frame_index)
    return aces_film(aovs.radiance)


def init_post_state(camera: Camera, config: RenderConfig):
    if config.denoising == DenoisingMode.PROGRESSIVE:
        return progressive_init(camera.width, camera.height)
    if config.denoising == DenoisingMode.TEMPORAL:
        return temporal_init(camera.width, camera.height)
    return None


def render_frame(scene: Scene, camera: Camera, config: RenderConfig,
                 state, frame_index=0):
    """Full frame-loop step: trace + denoise post-pass + display transform
    (path_tracing_camera.cpp:206-226). Returns (image [0,1], new_state)."""
    from gdpathtracing.post.display import display_transform

    aovs = render_radiance(scene, camera, config, frame_index)
    if config.denoising == DenoisingMode.PROGRESSIVE:
        assert isinstance(state, ProgressiveState)
        linear, state = progressive_update(state, aovs.radiance,
                                           camera.transform)
    elif config.denoising == DenoisingMode.TEMPORAL:
        assert isinstance(state, TemporalState)
        depth_nl = nonlinear_depth(aovs.depth, camera.near, camera.far)
        linear, state = temporal_update(state, aovs.radiance, depth_nl,
                                        camera.vp(),
                                        blend=config.temporal_blend,
                                        depth_eps=config.temporal_depth_eps)
    else:
        linear = aovs.radiance
    if config.spatial_denoise:
        from gdpathtracing.post.denoise import atrous_denoise
        linear = atrous_denoise(linear, aovs.normal, aovs.depth,
                                iterations=config.denoise_iterations)
    return display_transform(linear, config), state
