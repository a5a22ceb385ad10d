"""Interactive viewer: the analog of the reference's live viewport.

The reference's raison d'être is a movable camera over a live path-traced
view (PathTracingCamera::render per frame, path_tracing_camera.cpp:193-232,
driven by the WASD/mouse fly camera in project/demo/movable_camera.gd).
This viewer reproduces that loop headlessly:

- renders through ``Engine`` (temporal reprojection by default — the
  reference's denoising mode for a moving camera — or progressive, which
  auto-resets on motion exactly like progressive_rendering.cpp:53-60),
- displays frames in the terminal with truecolor half-block cells
  (2 pixels per character row),
- reads WASD / QE (down/up) / IJKL (look) / p (screenshot) / x (quit)
  from raw stdin without blocking the frame loop.

Scripted mode (no tty needed; used by tests/CI):
    python examples/viewer.py --script orbit --frames 24 --res 128
orbits the demo camera around the scene — every frame has real camera
motion, so the temporal-reprojection accept/reject path is exercised the
way the reference exercises it.

Keys: w/a/s/d move, q/e down/up, i/k pitch, j/l yaw, p screenshot, x quit.
"""

from __future__ import annotations

import argparse
import math
import select
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from render_demo import write_png  # minimal PNG writer (same directory)


def term_show(img_u8: np.ndarray) -> str:
    """(H, W, 3) uint8 → ANSI truecolor half-block string (H/2 lines)."""
    h = img_u8.shape[0] - (img_u8.shape[0] % 2)
    out = []
    for y in range(0, h, 2):
        top, bot = img_u8[y], img_u8[y + 1]
        line = []
        for x in range(img_u8.shape[1]):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg, bb = (int(v) for v in bot[x])
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


class FlyCamera:
    """WASD/yaw-pitch fly camera (movable_camera.gd:14-39 analog)."""

    def __init__(self, eye, yaw=0.0, pitch=0.0, speed=0.6, turn=0.12):
        self.eye = np.asarray(eye, np.float32)
        self.yaw = yaw        # radians, 0 = looking -Z
        self.pitch = pitch
        self.speed = speed
        self.turn = turn

    def forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.asarray([-math.sin(self.yaw) * cp,
                           math.sin(self.pitch),
                           -math.cos(self.yaw) * cp], np.float32)

    def right(self) -> np.ndarray:
        return np.asarray([math.cos(self.yaw), 0.0, -math.sin(self.yaw)],
                          np.float32)

    def apply(self, key: str) -> bool:
        """Returns True if the camera changed."""
        f, r = self.forward(), self.right()
        moves = {"w": f, "s": -f, "d": r, "a": -r,
                 "e": np.asarray([0, 1, 0], np.float32),
                 "q": np.asarray([0, -1, 0], np.float32)}
        if key in moves:
            self.eye = self.eye + moves[key] * self.speed
            return True
        turns = {"j": ("yaw", 1), "l": ("yaw", -1),
                 "i": ("pitch", 1), "k": ("pitch", -1)}
        if key in turns:
            attr, sgn = turns[key]
            setattr(self, attr, getattr(self, attr) + sgn * self.turn)
            self.pitch = max(-1.4, min(1.4, self.pitch))
            return True
        return False

    def camera(self, width: int, height: int, fov_deg: float = 79.5):
        from gdpathtracing.render.camera import Camera
        return Camera.looking_at(tuple(self.eye),
                                 tuple(self.eye + self.forward()),
                                 fov_deg=fov_deg, width=width, height=height)


def read_keys(timeout: float = 0.0) -> str:
    """Drain pending stdin bytes (raw mode) without blocking."""
    keys = ""
    while select.select([sys.stdin], [], [], timeout)[0]:
        keys += sys.stdin.read(1)
        timeout = 0.0
    return keys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=96,
                    help="viewport pixels (square; terminal shows res/2 rows)")
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--traversal", default="pallas",
                    choices=["pallas", "unit", "brute", "bvh", "mega"])
    ap.add_argument("--denoise", default="temporal",
                    choices=["temporal", "progressive", "none"])
    ap.add_argument("--script", default=None, choices=[None, "orbit"],
                    help="scripted camera path instead of keyboard input")
    ap.add_argument("--frames", type=int, default=24,
                    help="frame count in scripted mode")
    ap.add_argument("--out", default="out/viewer.png")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (tests)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from gdpathtracing import Engine, RenderConfig
    from gdpathtracing.config import DenoisingMode, Traversal
    from gdpathtracing.scene.demo import build_demo_scene

    scene = build_demo_scene(texture_resolution=32, sphere_detail=12)
    config = RenderConfig(
        bounces=args.bounces, spp=1,
        traversal=Traversal(args.traversal),
        denoising=DenoisingMode(args.denoise
                                if args.denoise != "none" else "none"),
    )
    engine = Engine(scene, config)
    fly = FlyCamera(eye=(0.0, 1.0, 9.7694))

    if args.script == "orbit":
        # Camera orbits the box: every frame moves → the temporal history
        # is reprojected (or the progressive accumulator resets) each step,
        # exactly the moving-camera regime of the reference demo.
        t_first = time.time()
        img = None
        for f in range(args.frames):
            ang = 0.35 * math.sin(2 * math.pi * f / args.frames)
            fly.yaw = ang
            fly.eye = np.asarray(
                [9.7694 * math.sin(ang), 1.0, 9.7694 * math.cos(ang)],
                np.float32)
            cam = fly.camera(args.res, args.res)
            img = engine.step(cam)
            if f == 0:
                img_np = np.asarray(img)
                print(f"first frame (incl. compile): "
                      f"{time.time() - t_first:.2f}s", flush=True)
                t_loop = time.time()
        img_np = np.asarray(img)
        dt = time.time() - t_loop
        fps = (args.frames - 1) / max(dt, 1e-9)
        assert np.isfinite(img_np).all()
        write_png(args.out, engine.to_uint8(img_np))
        print(f"{args.frames - 1} moving-camera frames in {dt:.2f}s "
              f"({fps:.1f} fps) -> {args.out}", flush=True)
        return

    # ---- interactive mode ----
    import termios
    import tty
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    shots = 0
    try:
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            cam = fly.camera(args.res, args.res)
            img = engine.to_uint8(engine.step(cam))
            sys.stdout.write("\x1b[H" + term_show(img) +
                             "\n\x1b[0mWASD move  QE up/down  IJKL look  "
                             "p shot  x quit   ")
            sys.stdout.flush()
            for key in read_keys(timeout=0.01):
                if key == "x":
                    return
                if key == "p":
                    shots += 1
                    path = f"out/viewer_shot{shots}.png"
                    write_png(path, img)
                else:
                    fly.apply(key)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


if __name__ == "__main__":
    main()
