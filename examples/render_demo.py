"""Render the demo scene (Cornell box + light + two spheres) and save PNGs.

The analog of running the reference's Godot demo (project/demo/demo.tscn):
progressive accumulation over N frames from the static demo camera.

Usage:
    python examples/render_demo.py [--res 512] [--frames 8] [--bounces 5]
                                   [--traversal bvh|brute] [--out out/demo.png]
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (no imaging deps in the base image)."""
    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
           chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--traversal", default="pallas",
                    choices=["pallas", "unit", "brute", "bvh", "mega"])
    ap.add_argument("--regen", action="store_true",
                    help="path-regeneration frame loop (render/regen.py)")
    ap.add_argument("--out", default="out/demo.png")
    args = ap.parse_args()

    from gdpathtracing import Engine, RenderConfig
    from gdpathtracing.config import Traversal
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera

    print("building scene...")
    scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
    print(f"  tris={scene.n_tris} instances={scene.n_instances} "
          f"materials={scene.n_materials}")
    camera = demo_camera(args.res, args.res)
    config = RenderConfig(bounces=args.bounces, spp=args.spp,
                          traversal=Traversal(args.traversal),
                          regen=args.regen or None)
    engine = Engine(scene, config)

    t0 = time.time()
    image = engine.step(camera)
    image.block_until_ready()
    print(f"first frame (incl. compile): {time.time() - t0:.2f}s")

    t0 = time.time()
    for _ in range(args.frames - 1):
        image = engine.step(camera)
    image.block_until_ready()
    dt = time.time() - t0
    n = max(args.frames - 1, 1)
    rays = args.res * args.res * args.spp
    print(f"{n} frames in {dt:.3f}s → {n / dt:.2f} fps, "
          f"{rays * n / dt / 1e6:.2f} Mpaths/s")

    write_png(args.out, engine.to_uint8(image))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
