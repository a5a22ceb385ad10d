"""Differentiable-path perf: fwd+bwd frame times of the differentiable
render with and without NEE and with the soft (silhouette gradient)
estimators at full resolution.

    python -u examples/diff_perf.py [--res 1080] [--frames 3]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.diff.inverse import image_mse, replace_albedo
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_demo_scene, demo_camera


def time_bwd(scene, cam, cfg, frames, label):
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)

    @jax.jit
    def run(fs):
        def body(g, f):
            albedo = scene.mat_albedo - 1e-30 * g
            def loss(a):
                aovs = render_radiance(replace_albedo(scene, a), cam,
                                       cfg, f)
                return image_mse(aovs.radiance, target)
            return jax.grad(loss)(albedo), None
        g, _ = jax.lax.scan(body, jnp.zeros_like(scene.mat_albedo),
                            jnp.asarray(fs, jnp.uint32))
        return g

    g = np.asarray(run([0] * frames))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    t0 = time.time()
    np.asarray(run(list(range(1, frames + 1))))
    dt = (time.time() - t0) / frames
    print(f"{label:42s} {dt*1e3:8.1f} ms/frame fwd+bwd", flush=True)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    w = {1080: 1920, 540: 960}.get(args.res, args.res)
    scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
    cam = demo_camera(w, args.res)
    base = RenderConfig(bounces=5, spp=1, traversal=Traversal.PALLAS,
                        differentiable=True)

    time_bwd(scene, cam, base, args.frames, "diff (no NEE)")
    time_bwd(scene, cam, base.replace(nee=True), args.frames, "diff NEE")
    time_bwd(scene, cam, base.replace(soft_shadows=0.02, nee=True),
             args.frames, "diff NEE + soft_shadows (silhouette)")
    time_bwd(scene, cam, base.replace(soft_primary=0.02), args.frames,
             "diff + soft_primary (silhouette)")


if __name__ == "__main__":
    main()
