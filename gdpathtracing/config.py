"""Render configuration.

The reference scatters its knobs between Godot editor properties and
hard-coded shader constants (SURVEY.md §5 "Config"): 5 bounces
(main.glsl:377), ray-offset epsilon 0.001 (main.glsl:385), temporal blend
0.75 (temporal_reprojection.glsl:64), near/far 0.01/1000
(render_parameters.h:20-21). Here every one of them is an explicit field of a
single hashable dataclass, used as a static argument to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import enum


class DenoisingMode(enum.Enum):
    """Analog of reference PathTracingCamera::DenoisingMode
    (path_tracing_camera.h:30-34)."""

    PROGRESSIVE = "progressive"
    TEMPORAL = "temporal"
    NONE = "none"


class Traversal(enum.Enum):
    """Which intersection backend the integrator uses."""

    BRUTE = "brute"  # O(rays x tris) Möller–Trumbore — the testing oracle
    BVH = "bvh"      # two-level TLAS/BLAS stack traversal (batched lax loop)
    UNIT = "unit"    # O(rays x tris) unit-triangle-space matmul formulation
    PALLAS = "pallas"  # fused Pallas kernel, Triton route on the GPU and
    #                    interpreted on the CPU (ops/intersect_pallas.py)


class Tonemap(enum.Enum):
    """Display operator — the reference hard-codes ACES
    (progressive_rendering.glsl:19-26)."""

    ACES = "aces"
    REINHARD = "reinhard"
    LINEAR = "linear"


class Jitter(enum.Enum):
    NONE = "none"
    UNIFORM = "uniform"   # uniform in [-0.5, 0.5]^2 around the pixel center
    GAUSS = "gauss"       # Gaussian, sigma = 0.375 px (proper Box–Muller; the
    #                       reference's box_muller drops the radius term —
    #                       main.glsl:183-187 — a bug we fix, not copy)
    CIRCLE = "circle"     # reference-compatible: point on the unit circle


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings. Hashable → usable as a jit static arg.

    Resolution, FOV and near/far live on :class:`render.camera.Camera`
    (the reference also sources them from the camera node,
    path_tracing_camera.cpp:124,134)."""

    bounces: int = 5          # reference hard-codes 5 (main.glsl:377)
    spp: int = 1              # samples/pixel/frame (reference: 1, main.glsl:405)
    ray_eps: float = 1e-3     # hit-point normal offset (main.glsl:385)
    nee: bool = False         # next-event estimation + MIS (beyond the
    #                           reference, whose transport is BRDF-sampling
    #                           only — README wishlist item)
    rr_start: int = 0         # Russian roulette from this bounce on (0 =
    #                           off, matching the reference, which has no
    #                           path-length control beyond the hard cap).
    #                           Survival prob = clamp(max(throughput),
    #                           rr_min_p, 1); throughput /= p on survival —
    #                           unbiased, detached for gradients.
    rr_min_p: float = 0.05    # survival-probability floor (variance guard)
    sort_rays: bool | None = None  # octant-sort the wavefront each bounce
    #                           (restores block coherence for the chunked
    #                           kernel on large scenes). None = auto: on
    #                           for PALLAS + >128-chunk scenes.
    compact_rays: bool | None = None  # stream-compact the wavefront
    #                           between bounces: stable partition of
    #                           128-ray GROUPS by any-live (cumsum, no
    #                           argsort; every permute is a contiguous
    #                           row gather). Dead groups pack into tail
    #                           blocks whose slab tests all fail, so
    #                           terminated paths cost zero sweeps (the
    #                           wavefront analog of SIMT early thread
    #                           exit, main.glsl:390-396); survivors keep
    #                           their pixel-coherent order. Per-ray
    #                           results (radiance, depth, segments) are
    #                           permutation-invariant, so it is
    #                           result-transparent. None = auto for
    #                           wavefront-PALLAS: on for >= 65536-ray
    #                           wavefronts whenever per-bounce sorting is
    #                           off (sort_rays keys dead rays last and so
    #                           subsumes it). In the regen loop False
    #                           turns the lane permutation off.
    regen: bool | None = None  # path-regeneration frame loop
    #                           (render/regen.py): a persistent wavefront
    #                           where dead lanes are refilled with the
    #                           next unstarted path, so sweeps stay ~100%
    #                           live instead of paying the flat per-bounce
    #                           cost of mostly-dead blocks. Primal only
    #                           (while_loop is not reverse-differentiable);
    #                           requires regen.regen_supported. None =
    #                           auto: ON for every supported PALLAS primal
    #                           render (regen.regen_auto); the standard
    #                           per-bounce loop remains the bit-golden
    #                           reference and the non-PALLAS default.
    differentiable: bool = False  # differentiable render path: PALLAS
    #                           traversal becomes a primal hit-finder with a
    #                           differentiable recompute epilogue
    #                           (ops/intersect_pallas.trace_pallas_diff) and
    #                           the bounce loop is jax.checkpoint'ed per
    #                           bounce so backward memory stays O(wavefront)
    #                           instead of O(wavefront x bounces x ops).
    #                           BRUTE/UNIT are differentiable regardless.
    bwd_checkpoint: bool | None = None  # differentiable mode:
    #                           jax.checkpoint each bounce (backward
    #                           recomputes the bounce interior; residual
    #                           memory stays O(wavefront)). False = let
    #                           the scan save every intermediate (no
    #                           recompute, more memory). None (default) =
    #                           SHAPE-AWARE auto: estimate residual bytes
    #                           (bwd_resid_bytes_per_seg per lane-bounce)
    #                           and checkpoint only when they exceed
    #                           bwd_resid_budget. Values/gradients are
    #                           identical either way (tests/test_diff.py
    #                           asserts both paths agree).
    # Residual-estimate constants for the bwd_checkpoint=None auto rule.
    bwd_resid_bytes_per_seg: int = 160
    bwd_resid_budget: int = 4 << 30
    grad_attached: bool = False  # gradient strategy for the sampling terms
    #                           (Mitsuba's attached/detached distinction).
    #                           False (default) = DETACHED: the sampled
    #                           bounce direction and every pdf are
    #                           stop-gradient'ed — the standard low-variance
    #                           unbiased estimator of dE[L]/dθ; per-sample
    #                           AD deliberately differs from FD of the
    #                           primal for parameters that move the samples
    #                           (vertices/normals/camera). True = ATTACHED:
    #                           nothing is detached, so jax.grad equals the
    #                           finite difference of the primal estimator
    #                           exactly (chain rule, fixed RNG) — what FD
    #                           gradient tests and reparameterization-style
    #                           estimators need. The primal image is
    #                           IDENTICAL either way.
    soft_shadows: float = 0.0  # > 0: differentiable soft-shadow visibility
    #                           with this barycentric edge width (NEE;
    #                           BRUTE/UNIT/PALLAS use the exact
    #                           all-triangle product of
    #                           intersect.occlusion_soft — gradients of
    #                           shadows w.r.t. blocker geometry, the
    #                           silhouette term hard visibility drops).
    #                           0 = hard.
    soft_primary: float = 0.0  # > 0: differentiable PRIMARY-visibility
    #                           silhouettes with this barycentric edge
    #                           width: the first hit blends toward the
    #                           environment as the winner's barycentric
    #                           edge margin -> 0 (SoftRas-style
    #                           relaxation; alpha = 2 sigmoid(m/eps) - 1
    #                           is continuous across the silhouette), so
    #                           pixel gradients w.r.t. object/camera pose
    #                           include the object-over-background
    #                           boundary term. Works on every
    #                           differentiable backend incl. PALLAS
    #                           (the recomputed winner u/v carry the
    #                           gradient). Bias O(eps) in silhouette
    #                           bands; 0 = hard (bit-identical goldens).
    traversal: Traversal = Traversal.BVH
    jitter: Jitter = Jitter.UNIFORM
    max_stack: int = 64       # traversal stack depth (main.glsl:272,307)
    tile_rays: int = 262144   # rays per traced tile (bounds live wavefront
    #                           memory; larger tiles amortize dispatch)
    regen_wavefront: int = 393216  # persistent-wavefront size of the
    #                           regeneration loop (render/regen.py).
    #                           Larger wavefronts amortize per-iteration
    #                           fixed costs; capped by the path-pool size.
    regen_retire: str = "log"   # regen retirement mechanism: "log"
    #                           (default) = contiguous retirement log —
    #                           after the lane permutation puts freshly
    #                           dead lanes in a contiguous block, one
    #                           dynamic_update_slice appends their packed
    #                           columns to a column-major log, and ONE
    #                           transpose+row-gather at frame end lands
    #                           everything pid-indexed. "scatter" =
    #                           per-iteration masked column scatters. The
    #                           log requires the lane permutation;
    #                           compact_rays=False falls back to
    #                           "scatter".
    regen_sort_key: str = "morton"  # regen lane-sort key: "morton" =
    #                           Morton(origin cell) x octant (default);
    #                           "chunk" = first chunk the ray enters x
    #                           octant — aligns blocks with the kernel's
    #                           unit of work (the chunk sweep) instead of
    #                           raw origin locality.
    regen_drain: bool | None = None  # two-phase drain (render/regen.py):
    #                           once the path pool is exhausted and the
    #                           live count fits, hand the sorted live
    #                           prefix to a second while_loop at a ~4x
    #                           smaller wavefront — the drain tail pays
    #                           per-iteration glue (permute, scan, DUS)
    #                           proportional to the wavefront, and the
    #                           tail is straggler-bound (last paths need
    #                           max-path-length more iterations). None =
    #                           auto (on for frames with n_paths >= 2*nw).
    regen_drain_wavefront: int | None = None  # phase-2 lane count
    #                           (None = nw//4 rounded to 256)
    temporal_blend: float = 0.75   # temporal_reprojection.glsl:64
    temporal_depth_eps: float = 0.1  # history-reject threshold (glsl:59)
    denoising: DenoisingMode = DenoisingMode.PROGRESSIVE
    # Spatial edge-aware denoiser (post/denoise.py), applied to the linear
    # image before the display transform:
    spatial_denoise: bool = False
    denoise_iterations: int = 3
    # Display transform (post/display.py):
    tonemap: Tonemap = Tonemap.ACES
    exposure: float = 1.0
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_strength: float = 0.15
    bloom_radius: int = 8
    # Sky gradient endpoints (main.glsl:189-192).
    sky_horizon: tuple[float, float, float] = (0.95, 0.95, 0.95)
    sky_zenith: tuple[float, float, float] = (0.9, 0.94, 1.0)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
