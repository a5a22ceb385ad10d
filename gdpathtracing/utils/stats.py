"""Observability: per-frame render statistics and debug AOV views.

Replaces the reference's ad-hoc instrumentation (SURVEY.md §5): the FPS
label (fps_meter.gd:3-4) becomes structured stats computed from the frame
AOVs; the DEBUG_STEPS traversal-cost heatmap (main.glsl:4,358-361,423-427)
becomes a normal AOV visualization.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from gdpathtracing.render.renderer import FrameAOVs


class FrameStats(NamedTuple):
    rays: int               # traced path segments
    mean_path_length: float  # segments / pixel / spp
    mean_tri_tests: float   # intersection tests per segment
    mrays_per_s: float      # requires elapsed seconds

    def as_dict(self) -> dict:
        return self._asdict()


def frame_stats(aovs: FrameAOVs, spp: int = 1,
                elapsed_s: float | None = None) -> FrameStats:
    segments = int(np.asarray(aovs.segments, dtype=np.int64).sum())
    steps = float(np.asarray(aovs.steps, dtype=np.float64).sum())
    n_pix = aovs.segments.size
    return FrameStats(
        rays=segments,
        mean_path_length=segments / max(n_pix * spp, 1),
        mean_tri_tests=steps / max(segments, 1),
        mrays_per_s=(segments / elapsed_s / 1e6) if elapsed_s else 0.0,
    )


def steps_heatmap(aovs: FrameAOVs, scale: float = 256.0) -> jnp.ndarray:
    """DEBUG_STEPS analog (main.glsl:358-361): grayscale traversal-cost
    image in [0,1], clamped at `scale` triangle tests."""
    v = jnp.clip(aovs.steps.astype(jnp.float32) / scale, 0.0, 1.0)
    return jnp.stack([v, v, v], axis=-1)
