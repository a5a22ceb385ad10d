"""Engine: owns the compiled render step + device-resident state.

This is where the reference's L2 "ComputeShader" orchestration layer
(SURVEY.md §2.7) lands in a JAX design: instead of explicit uniform
sets, buffer RIDs and dispatches, the Engine holds the scene pytree on
device, a jitted frame step (compiled once per (config, resolution)), and
the functional post-processing state which is donated between frames so XLA
updates it in place. The per-frame "camera UBO upload"
(path_tracing_camera.cpp:198-200) becomes simply passing a new Camera
pytree.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np

from gdpathtracing.config import RenderConfig
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import (init_post_state, render_frame)
from gdpathtracing.scene.scene import Scene


class Engine:
    """Stateful frame loop driver (analog of PathTracingCamera's
    init()/render() lifecycle, path_tracing_camera.cpp:111-232)."""

    def __init__(self, scene: Scene, config: RenderConfig | None = None):
        self.config = config or RenderConfig()
        self.scene = jax.device_put(scene)
        self.frame_index = 0
        self._state = None
        self._step = jax.jit(
            partial(render_frame, config=self.config),
            static_argnames=(),
            donate_argnames=("state",),
        )

    def reset(self, camera: Camera) -> None:
        self._state = init_post_state(camera, self.config)
        self.frame_index = 0

    def step(self, camera: Camera) -> np.ndarray:
        """Render one frame; returns the tonemapped image as (H, W, 3)
        float32 in [0, 1]."""
        if self._state is None:
            self.reset(camera)
        image, self._state = self._step(
            self.scene, camera, state=self._state,
            frame_index=self.frame_index)
        self.frame_index += 1
        return image

    def to_uint8(self, image) -> np.ndarray:
        return np.asarray(
            np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8))

    def profile(self, logdir: str):
        """jax.profiler trace context for the frame loop (SURVEY.md §5
        tracing analog):  with engine.profile('/tmp/trace'): engine.step(cam)
        """
        import jax.profiler
        return jax.profiler.trace(logdir)
