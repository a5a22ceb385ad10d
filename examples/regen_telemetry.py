"""Regen occupancy telemetry.

Renders one frame through render_radiance_regen(return_stats=True) and
prints the per-iteration table: live lanes and the triangles the trace
kernel swept for them (from its steps output). Run on the GPU from the
repo root:

    python -u examples/regen_telemetry.py --res 1080 [--scene grid]
        [--nee] [--nw 524288] [--sort-key chunk] [--no-sort]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.render.regen import render_radiance_regen
from gdpathtracing.scene.demo import (build_demo_scene, demo_camera,
                                          build_sphere_grid, grid_camera)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1080)
    ap.add_argument("--scene", default="demo", choices=["demo", "grid"])
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--nw", type=int, default=524288)
    ap.add_argument("--sort-key", default="morton",
                    choices=["morton", "chunk"])
    ap.add_argument("--no-sort", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    w = {1080: 1920, 540: 960, 256: 256}.get(args.res, args.res)
    h = args.res
    if args.scene == "grid":
        scene = build_sphere_grid(n=10, sphere_detail=16)
        camera = grid_camera(w, h, n=10)
    else:
        scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
        camera = demo_camera(w, h)
    cfg = RenderConfig(bounces=5, spp=1, traversal=Traversal.PALLAS,
                       nee=args.nee, regen=True,
                       regen_wavefront=args.nw,
                       regen_sort_key=args.sort_key,
                       sort_rays=False if args.no_sort else None)

    step = jax.jit(lambda f: render_radiance_regen(
        scene, camera, cfg, f, return_stats=True))
    print("compiling...", flush=True)
    t0 = time.time()
    aovs, stats = step(0)
    rad = np.asarray(aovs.radiance)
    assert np.isfinite(rad).all()
    print(f"compile+frame0: {time.time() - t0:.1f}s", flush=True)

    # Timed frames (full transfer barrier).
    dts = []
    for f in range(1, args.frames + 1):
        t0 = time.time()
        aovs, stats = step(f)
        np.asarray(aovs.radiance)
        dts.append(time.time() - t0)
    dt = sorted(dts)[len(dts) // 2]
    segs = float(np.asarray(aovs.segments, np.float64).sum())
    print(f"{dt*1e3:.1f} ms/frame  {segs/1e6:.2f} Mseg  "
          f"{segs/dt/1e6:.2f} Mrays/s  (stats overhead included)")

    iters = int(np.asarray(stats["iters"]))
    alive = np.asarray(stats["it_alive"])[:iters]
    steps = np.asarray(stats["it_steps"])[:iters]
    print(f"iters={iters} nw={args.nw}")
    print("  it   alive%   tri-tests/live-lane")
    for i in range(iters):
        print(f"  {i:3d}  {100*alive[i]/args.nw:6.1f}  "
              f"{steps[i]/max(alive[i], 1):10.1f}")
    print(f"total triangle tests: {steps.sum():.0f}")


if __name__ == "__main__":
    main()
