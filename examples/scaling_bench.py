"""Scaling-efficiency sweep (BASELINE: ≥80% rays/s efficiency).

Renders the same frame on meshes of 1, 2, 4, … devices and reports rays/s
scaling efficiency. On several GPUs this measures NVLink-connected
scaling; on a virtual CPU mesh it validates the mechanism.

Usage:  python examples/scaling_bench.py [--res 512] [--devices 8]
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
    ap.add_argument("--devices", type=int, default=0,
                    help="max devices (0 = all)")
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--traversal", default="unit")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    import jax

    if len(jax.devices()) < 2:
        try:
            jax.config.update("jax_num_cpu_devices", 8)
        except RuntimeError:
            pass
    devices = jax.devices()
    if len(devices) < 2:
        devices = jax.devices("cpu")

    import numpy as np

    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.parallel.sharding import (make_mesh,
                                                     render_radiance_sharded)
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera

    max_dev = args.devices or len(devices)
    scene = build_demo_scene(texture_resolution=8, sphere_detail=8, geometry="sphere")
    cam = demo_camera(args.res, args.res)
    cfg = RenderConfig(bounces=args.bounces, spp=1,
                       traversal=Traversal(args.traversal))

    results = {}
    n = 1
    while n <= max_dev:
        mesh = make_mesh(devices[:n])
        step = jax.jit(
            lambda s, c, f, m=mesh: render_radiance_sharded(s, c, cfg, f, m))
        aovs = step(scene, cam, 0)
        aovs.radiance.block_until_ready()
        seg = float(np.asarray(aovs.segments, dtype=np.float64).sum())
        t0 = time.time()
        for f in range(1, args.frames + 1):
            aovs = step(scene, cam, f)
        aovs.radiance.block_until_ready()
        dt = (time.time() - t0) / args.frames
        results[n] = seg / dt
        eff = results[n] / (results[1] * n) * 100.0
        print(f"devices={n:2d}  {seg / dt / 1e6:8.3f} Mrays/s  "
              f"efficiency={eff:6.1f}%", flush=True)
        n *= 2


if __name__ == "__main__":
    main()
