"""On-device sharded validation: compile and run the real shard_map +
PALLAS path on the accelerator with a 1-device mesh and assert
bit-equality against the unsharded render.

The CPU-mesh tests (tests/test_sharding.py) exercise the same code in
interpret mode only; this script is the missing "a compiled
pallas-under-shard_map program has executed on hardware" evidence. Run:

    python -u examples/sharded_onchip.py [--res 256] [--nee] [--diff]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--diff", action="store_true",
                    help="also check a sharded differentiable-PALLAS "
                         "gradient (albedo) against the unsharded one")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gdpathtracing.config import RenderConfig, Traversal, Jitter
    from gdpathtracing.parallel.sharding import (make_mesh,
                                                     render_radiance_sharded)
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera

    devs = jax.devices()
    print(f"devices: {devs}", flush=True)
    mesh = make_mesh(devs[:1])

    scene = build_demo_scene(texture_resolution=8, sphere_detail=8)
    cam = demo_camera(args.res, args.res)
    cfg = RenderConfig(bounces=args.bounces, spp=1,
                       traversal=Traversal.PALLAS, jitter=Jitter.UNIFORM,
                       nee=args.nee)

    t0 = time.time()
    base = jax.jit(lambda f: render_radiance(scene, cam, cfg, f))(3)
    base_rad = np.asarray(base.radiance)
    print(f"unsharded compile+run: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    sh = jax.jit(lambda f: render_radiance_sharded(scene, cam, cfg, f,
                                                   mesh))(3)
    sh_rad = np.asarray(sh.radiance)
    print(f"sharded (1-dev mesh) compile+run: "
          f"{time.time() - t0:.1f}s", flush=True)

    np.testing.assert_array_equal(sh_rad, base_rad)
    np.testing.assert_array_equal(np.asarray(sh.depth),
                                  np.asarray(base.depth))
    np.testing.assert_array_equal(np.asarray(sh.segments),
                                  np.asarray(base.segments))
    print("OK: compiled sharded PALLAS render bit-matches unsharded "
          f"on {devs[0]}", flush=True)

    if args.diff:
        from gdpathtracing.diff.inverse import image_mse, replace_albedo
        dcfg = cfg.replace(differentiable=True, bounces=2)
        target = jnp.zeros((args.res, args.res, 3), jnp.float32)

        def loss_sharded(albedo):
            aovs = render_radiance_sharded(replace_albedo(scene, albedo),
                                           cam, dcfg, 3, mesh)
            return image_mse(aovs.radiance, target)

        def loss_base(albedo):
            aovs = render_radiance(replace_albedo(scene, albedo), cam,
                                   dcfg, 3)
            return image_mse(aovs.radiance, target)

        t0 = time.time()
        g_sh = np.asarray(jax.jit(jax.grad(loss_sharded))(scene.mat_albedo))
        print(f"sharded grad compile+run: {time.time() - t0:.1f}s",
              flush=True)
        g_b = np.asarray(jax.jit(jax.grad(loss_base))(scene.mat_albedo))
        assert np.isfinite(g_sh).all() and np.abs(g_sh).max() > 0
        np.testing.assert_allclose(g_sh, g_b, rtol=1e-6, atol=1e-8)
        print("OK: compiled sharded differentiable-PALLAS gradient matches "
              "unsharded", flush=True)


if __name__ == "__main__":
    main()
