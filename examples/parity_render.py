"""Reference-parity artifact: render the
demo.tscn scene at 1080p with NEE + progressive accumulation and save a
PNG beside the reference's banner.png for the visual-parity note in
docs/PARITY.md.

Note the reference banner was rendered from a scene variant with a robot
model that ships in neither repo (only cornell.obj / suzanne.obj are in
project/demo/geometry); the reproducible comparison is the demo.tscn
scene itself — Cornell box + emissive suzanne + mirror suzanne — whose
geometry, transforms, materials and camera this repo transcribes exactly
(scene/demo.py, demo.tscn:49-93).

Run: python -u examples/parity_render.py [--frames 48] [--out docs/...]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def write_png(path, img_u8):
    import zlib
    import struct
    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--out", default="docs/demo_1080p_nee.png")
    args = ap.parse_args()

    import jax
    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.render.engine import Engine
    from gdpathtracing.scene.demo import build_demo_scene, demo_camera

    scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
    camera = demo_camera(args.width, args.height)
    config = RenderConfig(bounces=args.bounces, traversal=Traversal.PALLAS,
                          nee=True)
    engine = Engine(scene, config)
    t0 = time.time()
    image = engine.step(camera)
    print(f"first frame (incl. compile): {time.time() - t0:.1f}s",
          flush=True)
    t0 = time.time()
    for _ in range(args.frames - 1):
        image = engine.step(camera)
    img = np.asarray(engine.to_uint8(image))
    print(f"{args.frames - 1} more frames: {time.time() - t0:.1f}s")
    write_png(args.out, img)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
