"""Multi-chip rendering: shard the ray wavefront over a device mesh.

New capability with no reference counterpart (the reference is a single
local Vulkan device, path_tracing_camera.cpp:114; SURVEY.md §2 "Parallelism
& distributed components"). Design per SURVEY.md §7 step 7:

- **Scene replicated, rays sharded** — scene buffers are read-only per
  frame (the reference's set-1 SSBOs), so they carry ``P()`` (replicated)
  while pixel ids carry ``P('chips')``.
- **Interleaved (strided) pixel assignment** — chip c owns pixels
  ``c, c+N, c+2N, …`` rather than contiguous tiles, so a sky-heavy region
  doesn't idle one chip while another traverses deep BVH paths
  (load-balance mitigation from SURVEY.md §7 "hard part #3").
- **Deterministic under resharding** — the RNG stream is keyed by
  (pixel, frame) (rng.prng_seed), never by chip id, so an N-chip render
  bit-matches the single-chip render (SURVEY.md §4f).
- Gradients of sharded renders w.r.t. replicated scene parameters
  all-reduce automatically: the transpose of a replicated ``P()`` input in
  ``shard_map`` inserts the ``psum``.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh;
the same code then spans hosts (XLA hands the collectives to NCCL).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gdpathtracing.config import RenderConfig
from gdpathtracing.core import rng
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.integrator import get_trace_fn, path_trace
from gdpathtracing.render.renderer import FrameAOVs
from gdpathtracing.scene.scene import Scene

AXIS = "chips"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _trace_pixels(scene: Scene, camera: Camera, pids: jnp.ndarray,
                  frame_index, config: RenderConfig):
    """Trace a flat batch of pixel ids → (rgb (n,3), depth (n,), steps (n,))."""
    trace_fn = get_trace_fn(config, scene)
    px = (pids % camera.width).astype(jnp.uint32)
    py = (pids // camera.width).astype(jnp.uint32)
    n = pids.shape[0]
    acc = [jnp.zeros(n, jnp.float32) for _ in range(3)]
    depth = None
    steps = jnp.zeros(n, jnp.int32)
    segments = jnp.zeros(n, jnp.int32)
    normal = None
    for s in range(config.spp):
        seed = rng.prng_seed(px, py,
                             jnp.uint32(frame_index) * jnp.uint32(config.spp)
                             + jnp.uint32(s))
        ray, seed = camera.generate_rays(pids, seed, config)
        res = path_trace(scene, ray, seed, config, trace_fn, far=camera.far)
        acc = [acc[0] + res.radiance.x, acc[1] + res.radiance.y,
               acc[2] + res.radiance.z]
        depth = res.depth if depth is None else jnp.minimum(depth, res.depth)
        steps = steps + res.steps
        segments = segments + res.segments
        if normal is None:
            normal = res.normal.to_array()
    inv = 1.0 / config.spp
    rgb = jnp.stack([a * inv for a in acc], axis=-1)
    return rgb, depth, steps, segments, normal


def render_radiance_sharded(scene: Scene, camera: Camera,
                            config: RenderConfig, frame_index,
                            mesh: Mesh) -> FrameAOVs:
    """Full-frame render with rays sharded over `mesh` (axis 'chips').

    Inside jit, XLA partitions the trace across chips; the only collective
    is the implicit all-gather of per-chip pixel results at the output.
    """
    w, h = camera.width, camera.height
    n_pix = w * h
    n_chips = mesh.devices.size
    per_chip = -(-n_pix // n_chips)
    padded = per_chip * n_chips

    # Interleaved assignment: position k on chip c handles pixel k*N + c.
    flat_ids = jnp.arange(padded, dtype=jnp.int32) % n_pix

    # A pallas_call declares no varying mesh axes for its outputs, and in
    # interpret mode (the CPU-mesh tests) the kernel jaxpr runs with the
    # interpreter's unvaried loop state, so PALLAS renders skip check_vma
    # (the per-ray math is device-local either way; bit-equality vs the
    # single-device render is asserted in tests/test_sharding.py).
    from gdpathtracing.config import Traversal
    check_vma = config.traversal != Traversal.PALLAS

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(AXIS), P()),
             out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
             check_vma=check_vma)
    def step(scene, camera, pids, frame_index):
        return _trace_pixels(scene, camera, pids, frame_index, config)

    # Strided layout: reshape (per_chip, n_chips) -> transpose so the
    # sharded leading axis interleaves pixels across chips.
    ids_strided = flat_ids.reshape(per_chip, n_chips).T.reshape(padded)
    rgb, depth, steps, segments, normal = step(
        scene, camera, ids_strided, jnp.asarray(frame_index, jnp.uint32))

    def deinterleave3(a):
        return a.reshape(n_chips, per_chip, 3).transpose(1, 0, 2).reshape(padded, 3)

    def deinterleave(a):
        return a.reshape(n_chips, per_chip).T.reshape(padded)

    return FrameAOVs(
        radiance=deinterleave3(rgb)[:n_pix].reshape(h, w, 3),
        depth=deinterleave(depth)[:n_pix].reshape(h, w),
        steps=deinterleave(steps)[:n_pix].reshape(h, w),
        segments=deinterleave(segments)[:n_pix].reshape(h, w),
        normal=deinterleave3(normal)[:n_pix].reshape(h, w, 3),
    )
