"""Benchmark: traced segments per second and ms per frame, 1 spp at 1080p.

The default run (no args) measures all four axes — demo primal, demo NEE,
backward (value_and_grad of an image loss w.r.t. albedo) and the
100-instance sphere grid — each in its own subprocess, one after another,
so that only one process holds the accelerator at a time. The parent never
opens a JAX backend. Every axis line names the device it ran on; an axis
that fails makes the whole run exit non-zero.

"Rays" = ray-trace queries actually issued (path segments), counted exactly
by the integrator's `segments` AOV — not the optimistic W*H*bounces.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

AXES = {
    # axis -> (extra argv, timeout_s)
    "primal": ([], 2400),
    "nee": (["--nee", "--frames", "4"], 2400),
    "backward": (["--backward", "--frames", "3"], 3000),
    "grid": (["--scene", "grid", "--frames", "3"], 2400),
}


def run_all_axes(verbose: bool) -> int:
    """Default mode: measure every axis in a subprocess, emit ONE line.
    Returns the exit code: non-zero if any axis failed."""
    results: dict[str, dict] = {}
    failed = []
    for axis, (argv, tmo) in AXES.items():
        cmd = [sys.executable, "-u", __file__, "--only", axis] + argv
        if verbose:
            print(f"[bench] {axis}: {' '.join(cmd)}", file=sys.stderr,
                  flush=True)
        t0 = time.time()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=tmo)
        except subprocess.TimeoutExpired:
            failed.append(f"{axis}: timed out after {tmo}s")
            continue
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            failed.append(f"{axis}: exit {out.returncode}\n"
                          f"{out.stderr[-4000:]}")
            continue
        try:
            results[axis] = json.loads(lines[-1])
        except json.JSONDecodeError:
            failed.append(f"{axis}: last line is not JSON: {lines[-1]!r}")
            continue
        if verbose:
            print(f"[bench] {axis}: {results[axis]} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    if failed:
        for f in failed:
            print(f"[bench] FAILED {f}", file=sys.stderr)
        return 1
    extra = {}
    for k, r in results.items():
        if k != "primal":
            extra[f"{k}_mrays"] = r["value"]
        extra[f"{k}_ms"] = r["ms_per_frame"]
    extra["nee_over_primal_time"] = round(
        results["nee"]["ms_per_frame"] / results["primal"]["ms_per_frame"],
        3)
    primal = results["primal"]
    print(json.dumps({
        "metric": "Mrays/s primal 1spp 1920x1080 pallas demo",
        "value": primal["value"],
        "unit": "Mrays/s",
        "device": primal["device"],
        "extra": extra,
    }))
    return 0


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    choices=["primal", "nee", "backward", "grid"],
                    help="measure a single axis in-process (the no-arg "
                         "default orchestrates all four in subprocesses)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--traversal", default=None,
                    help="pallas|unit|brute|bvh (default pallas)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation + MIS (shadow rays counted "
                         "as segments)")
    ap.add_argument("--tile-rays", type=int, default=None,
                    help="override config.tile_rays (rays per traced tile)")
    ap.add_argument("--sort", action="store_true",
                    help="force per-bounce ray sorting")
    ap.add_argument("--no-sort", action="store_true",
                    help="force per-bounce ray sorting off")
    ap.add_argument("--compact", action="store_true",
                    help="force survivor stream compaction on")
    ap.add_argument("--no-compact", action="store_true",
                    help="force stream compaction off")
    ap.add_argument("--sort-key", default=None,
                    choices=["morton", "chunk"],
                    help="regen lane-sort key (config.regen_sort_key): "
                         "morton = origin-cell x octant; chunk = first "
                         "chunk/superchunk entered x octant")
    ap.add_argument("--regen", action="store_true",
                    help="path-regeneration frame loop (persistent "
                         "always-full wavefront, render/regen.py)")
    ap.add_argument("--no-regen", action="store_true",
                    help="force the standard per-bounce loop")
    ap.add_argument("--scene", default="demo",
                    choices=["demo", "mid", "grid"],
                    help="demo = reference Cornell scene (~2k tris); "
                         "mid = 16-instance sphere grid (~9k tris, ~35 "
                         "chunks); grid = 100-instance sphere grid "
                         "(~100k tris)")
    ap.add_argument("--backward", action="store_true",
                    help="measure the BACKWARD pass: value_and_grad of an "
                         "image MSE w.r.t. the material albedo table "
                         "through the differentiable path; Mrays/s counts "
                         "the forward segments once")
    ap.add_argument("--drain-nw", type=int, default=None,
                    help="first drain-stage wavefront "
                         "(regen_drain_wavefront; default nw//4)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    if args.only is None and set(sys.argv[1:]) <= {"--verbose"}:
        sys.exit(run_all_axes(args.verbose))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import (build_demo_scene, demo_camera,
                                          build_sphere_grid, grid_camera)
    from gdpathtracing.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = _device()
    traversal = Traversal(args.traversal) if args.traversal else Traversal.PALLAS

    if args.scene == "grid":
        scene = build_sphere_grid(n=10, sphere_detail=16)
        camera = grid_camera(args.width, args.height, n=10)
    elif args.scene == "mid":
        scene = build_sphere_grid(n=4, sphere_detail=12)
        camera = grid_camera(args.width, args.height, n=4)
    else:
        scene = build_demo_scene(texture_resolution=64, sphere_detail=16)
        camera = demo_camera(args.width, args.height)
    config = RenderConfig(bounces=args.bounces, spp=args.spp,
                          traversal=traversal, nee=args.nee)
    if args.tile_rays:
        config = config.replace(tile_rays=args.tile_rays,
                                regen_wavefront=args.tile_rays)
    if args.sort:
        config = config.replace(sort_rays=True)
    if args.no_sort:
        config = config.replace(sort_rays=False)
    if args.compact:
        config = config.replace(compact_rays=True)
    if args.no_compact:
        config = config.replace(compact_rays=False)
    if args.sort_key:
        config = config.replace(regen_sort_key=args.sort_key)
    if args.drain_nw is not None:
        config = config.replace(regen_drain_wavefront=args.drain_nw)
    if args.regen:
        config = config.replace(regen=True)
    if args.no_regen:
        config = config.replace(regen=False)

    def report(kind, segments_per_frame, ms):
        print(json.dumps({
            "metric": f"Mrays/s {kind} {args.spp}spp "
                      f"{args.width}x{args.height} {traversal.value} "
                      f"{args.scene}",
            "value": round(segments_per_frame / ms / 1e3, 3),
            "unit": "Mrays/s",
            "ms_per_frame": round(ms, 3),
            "device": device,
        }))

    # Most axes run all frames inside ONE jitted program (lax.scan) and
    # return a scalar checksum per frame, so the timing holds no host
    # round trip per frame and no image transfer. The grid scene times a
    # per-frame host loop instead; its frames are long enough that one
    # dispatch per frame is negligible.
    if args.scene in ("grid", "mid"):
        step = jax.jit(lambda s, c, f:
                       render_radiance(s, c, config, f))
        if args.verbose:
            print("compiling (grid, host-loop timing)...", file=sys.stderr)
        t0 = time.time()
        aovs = step(scene, camera, 0)
        rad_np = np.asarray(aovs.radiance)
        assert np.isfinite(rad_np).all()
        if args.verbose:
            print(f"compile+first frame: {time.time() - t0:.1f}s",
                  file=sys.stderr)
        # Segment count is measured on frame 0 and assumed representative
        # of the timed frames (paths differ only by RNG); the median
        # frame time keeps one slow outlier from skewing the quotient.
        segments = float(np.asarray(aovs.segments, np.float64).sum())
        dts = []
        for f in range(1, args.frames + 1):
            t0 = time.time()
            np.asarray(step(scene, camera, f).radiance)
            dts.append(time.time() - t0)
        dt = sorted(dts)[len(dts) // 2]
        if args.verbose:
            print(f"{dt*1e3:.1f} ms/frame ({segments/1e6:.2f} M segments)",
                  file=sys.stderr)
        report("primal", segments, dt * 1e3)
        return

    if args.backward:
        from gdpathtracing.diff.inverse import image_mse, replace_albedo
        config = config.replace(differentiable=True)
        target = jnp.zeros((args.height, args.width, 3), jnp.float32)

        @jax.jit
        def run_bwd(s, c, frames):
            def loss_fn(albedo, f):
                aovs = render_radiance(replace_albedo(s, albedo), c,
                                       config, f)
                return image_mse(aovs.radiance, target), aovs.segments

            def body(carry, f):
                g, _ = carry
                # Serialize iterations: albedo depends on the previous
                # gradient (real optimizer shape; nothing hoistable —
                # 1e-30 scale keeps the value bit-stable without letting
                # XLA fold the dependency away).
                albedo = s.mat_albedo - 1e-30 * g
                (loss, segs), grad = jax.value_and_grad(
                    loss_fn, has_aux=True)(albedo, f)
                return (grad, segs), loss
            (g, segs), losses = jax.lax.scan(
                body, (jnp.zeros_like(s.mat_albedo),
                       jnp.zeros((c.height, c.width), jnp.int32)),
                jnp.asarray(frames, jnp.uint32))
            return g, segs, losses

        if args.verbose:
            print(f"compiling backward ({traversal.value}, "
                  f"{args.width}x{args.height}, {args.bounces} bounces)...",
                  file=sys.stderr)
        t0 = time.time()
        g, segs, losses = run_bwd(scene, camera, [0] * args.frames)
        g_np = np.asarray(g)
        assert np.isfinite(g_np).all() and np.abs(g_np).max() > 0.0
        if args.verbose:
            print(f"compile+warmup ({args.frames} frames): "
                  f"{time.time() - t0:.1f}s", file=sys.stderr)
        segments = float(np.asarray(segs, dtype=np.float64).sum())
        t0 = time.time()
        g, _, _ = run_bwd(scene, camera, list(range(1, args.frames + 1)))
        np.asarray(g)
        dt = time.time() - t0
        if args.verbose:
            print(f"{dt / args.frames * 1e3:.1f} ms/frame fwd+bwd "
                  f"({segments / 1e6:.2f} M segments)", file=sys.stderr)
        report("backward", segments, dt / args.frames * 1e3)
        return

    @jax.jit
    def run_full(s, c, frames):
        """Warmup/validation variant: returns the full image + segments."""
        def body(carry, f):
            aovs = render_radiance(s, c, config, f)
            return (aovs.radiance, aovs.segments), ()
        (rad, segs), _ = jax.lax.scan(
            body, (jnp.zeros((c.height, c.width, 3), jnp.float32),
                   jnp.zeros((c.height, c.width), jnp.int32)),
            jnp.asarray(frames, jnp.uint32))
        return rad, segs

    @jax.jit
    def run(s, c, frames):
        """Timed variant: every frame does full work; only a scalar
        checksum leaves the device."""
        def body(chk, f):
            aovs = render_radiance(s, c, config, f)
            return chk * 1e-30 + aovs.radiance.sum(), None
        chk, _ = jax.lax.scan(body, jnp.float32(0.0),
                              jnp.asarray(frames, jnp.uint32))
        return chk

    if args.verbose:
        print(f"compiling ({traversal.value}, {args.width}x{args.height}, "
              f"{args.bounces} bounces)...", file=sys.stderr)
    t0 = time.time()
    rad, segs = run_full(scene, camera, [0] * args.frames)
    rad_np = np.asarray(rad)
    assert np.isfinite(rad_np).all()
    segments = float(np.asarray(segs, dtype=np.float64).sum())
    np.asarray(run(scene, camera, [0] * args.frames))  # compile timed form
    if args.verbose:
        print(f"compile+warmup ({args.frames} frames): "
              f"{time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    chk = run(scene, camera, list(range(1, args.frames + 1)))
    assert np.isfinite(np.asarray(chk))
    dt = time.time() - t0
    if args.verbose:
        print(f"{dt / args.frames * 1e3:.1f} ms/frame "
              f"({segments/1e6:.2f} M segments)", file=sys.stderr)
    report("nee" if args.nee else "primal", segments,
           dt / args.frames * 1e3)


if __name__ == "__main__":
    main()
