"""Command-line interface: `python -m gdpathtracing ...`.

The user surface of the framework (the reference's analog is the Godot
editor + demo project; here a renderer is a command):

  render   render a JSON scene (or the built-in demo) to PNG
  info     print scene statistics (the VERBOSE_BVH_BUILDING analog)
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np


def write_png(path, img_u8: np.ndarray) -> None:
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


def cmd_render(args) -> None:
    from gdpathtracing import Engine, RenderConfig
    from gdpathtracing.config import DenoisingMode, Traversal

    if args.scene == "demo":
        from gdpathtracing.scene.demo import build_demo_scene, demo_camera
        scene = build_demo_scene()
        camera = demo_camera(args.width, args.height, fov_deg=args.fov)
    else:
        from gdpathtracing.scene.sceneformat import load_scene_file
        scene, camera = load_scene_file(args.scene, width=args.width,
                                        height=args.height)
    from gdpathtracing.config import Tonemap
    config = RenderConfig(bounces=args.bounces, spp=args.spp,
                          traversal=Traversal(args.traversal),
                          denoising=DenoisingMode(args.denoising),
                          nee=args.nee,
                          spatial_denoise=args.spatial_denoise,
                          tonemap=Tonemap(args.tonemap),
                          exposure=args.exposure,
                          bloom=args.bloom)
    engine = Engine(scene, config)
    t0 = time.time()
    image = engine.step(camera)
    image.block_until_ready()
    print(f"first frame (incl. compile): {time.time() - t0:.2f}s",
          file=sys.stderr)
    t0 = time.time()
    for _ in range(args.frames - 1):
        image = engine.step(camera)
    image.block_until_ready()
    if args.frames > 1:
        dt = time.time() - t0
        print(f"{args.frames - 1} frames in {dt:.3f}s "
              f"({(args.frames - 1) / dt:.2f} fps)", file=sys.stderr)
    write_png(args.out, engine.to_uint8(image))
    print(args.out)


def cmd_info(args) -> None:
    if args.scene == "demo":
        from gdpathtracing.scene.demo import build_demo_scene
        scene = build_demo_scene()
    else:
        from gdpathtracing.scene.sceneformat import load_scene_file
        scene, _ = load_scene_file(args.scene)
    print(json.dumps({
        "triangles": int(scene.n_tris),
        "expanded_triangles": int(scene.isect_mu.shape[1]),
        "instances": int(scene.n_instances),
        "materials": int(scene.n_materials),
        "blas_nodes": int(scene.node_min.shape[0]),
        "tlas_nodes": int(scene.tlas_min.shape[0]),
        "textures": list(map(int, scene.textures.shape)),
    }, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="gdpathtracing")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("scene", help="scene JSON path, or 'demo'")
    r.add_argument("--out", default="out/render.png")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--frames", type=int, default=8)
    r.add_argument("--spp", type=int, default=1)
    r.add_argument("--bounces", type=int, default=5)
    r.add_argument("--fov", type=float, default=79.5)
    r.add_argument("--traversal", default="pallas",
                   choices=["pallas", "unit", "brute", "bvh"])
    r.add_argument("--denoising", default="progressive",
                   choices=["progressive", "temporal", "none"])
    r.add_argument("--nee", action="store_true",
                   help="next-event estimation + MIS (lower variance)")
    r.add_argument("--spatial-denoise", action="store_true",
                   help="edge-aware a-trous filter on the output")
    r.add_argument("--tonemap", default="aces",
                   choices=["aces", "reinhard", "linear"])
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--bloom", action="store_true")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="print scene statistics")
    i.add_argument("scene")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    from gdpathtracing.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
