"""On-device validation of the path-regeneration frame loop
(render/regen.py): render one demo frame with the standard per-bounce loop
and one with regeneration, compare pixels, and report. Small resolution
first (cheap compile) before 1080p.

Run: python -u examples/regen_check.py [--res 512] [--nee]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_demo_scene, demo_camera


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--tile-rays", type=int, default=262144)
    args = ap.parse_args()

    scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
    camera = demo_camera(args.res, args.res)
    cfg = RenderConfig(bounces=args.bounces, traversal=Traversal.PALLAS,
                       nee=args.nee, tile_rays=args.tile_rays,
                       regen_wavefront=args.tile_rays)

    for name, config in (("standard", cfg.replace(regen=False)),
                         ("regen", cfg.replace(regen=True))):
        t0 = time.time()
        aovs = jax.jit(lambda f, c=config: render_radiance(
            scene, camera, c, f))(3)
        rad = np.asarray(aovs.radiance)
        segs = np.asarray(aovs.segments, np.float64).sum()
        print(f"{name:9s}: compile+frame {time.time()-t0:.1f}s  "
              f"finite={np.isfinite(rad).all()}  mean={rad.mean():.6f}  "
              f"segs={segs/1e6:.3f}M", flush=True)
        if name == "standard":
            ref, ref_segs = rad, segs
        else:
            exact = float((rad == ref).all(axis=-1).mean())
            close = np.allclose(rad, ref, rtol=1e-5, atol=1e-5)
            print(f"regen vs standard: exact-pixel fraction {exact:.6f}, "
                  f"allclose={close}, max|d|={np.abs(rad-ref).max():.3g}, "
                  f"segs equal={segs == ref_segs}", flush=True)


if __name__ == "__main__":
    main()
