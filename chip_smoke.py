"""Smoke test of the renderer on one GPU, through its normal entry points.

    python chip_smoke.py            # phases 1-8 on one card
    python chip_smoke.py --four     # the four-card sharded frame + gradient

Phases (each prints one line; any failure exits non-zero):
  1. device: JAX platform, kind and count, and nvidia-smi name/power limit;
  2. kernel vs oracle: closest hit and occlusion of the compiled trace
     kernel against trace_brute on 2^20 camera and random rays (with an
     active mask; the random set is not a multiple of the ray block), on
     the demo and the 100-instance grid scene;
  3. demo primal frame, 1920x1080, 1 spp, 5 bounces (regen loop) against a
     BRUTE frame of the same seed;
  4. the same with next-event estimation;
  5. one backward step (value_and_grad of an image MSE w.r.t. albedo) at
     1080p, and at 256x256 against the UNIT backend's gradient;
  6. grid frame at 1080p, and the kernel's hits against trace_bvh on a
     2^18-ray subsample;
  7. ms/frame of phases 3-6 (information, not a claim);
  8. last line: {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

W, H, BOUNCES = 1920, 1080, 5
N_RAYS = 1 << 20      # phase-2 rays per set
N_BVH_RAYS = 1 << 18  # phase-6 rays per set


def nvidia_smi() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines())


def result_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded frame and "
                         "gradient against the one-card ones")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gdpathtracing.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    devices = jax.devices()
    card = nvidia_smi()
    say("1 device", f"platform={devices[0].platform} "
        f"kind={devices[0].device_kind} count={len(devices)} "
        f"nvidia-smi: {card}")
    if args.four:
        check(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
        four_cards(devices[:4], card)
        print(result_line(devices[:4]))
        return 0
    times = {}
    kernel_vs_oracle()
    times.update(demo_frames())
    times.update(backward_step())
    times.update(grid_frame())
    say("7 timing", " ".join(f"{k}={v:.3f}ms/frame" for k, v in
                             times.items()) + f" on {card}")
    print(result_line(devices))
    return 0


# ---------------------------------------------------------------------------


@functools.cache
def _scenes():
    from gdpathtracing.scene.demo import (build_demo_scene, build_sphere_grid,
                                          demo_camera, grid_camera)
    return {
        "demo": (build_demo_scene(texture_resolution=64, sphere_detail=16),
                 demo_camera(W, H)),
        "grid": (build_sphere_grid(n=10, sphere_detail=16),
                 grid_camera(W, H, n=10)),
    }


def _camera_rays(cam, n, seed):
    """n camera rays at random pixels of the whole frame."""
    import jax
    import jax.numpy as jnp
    from gdpathtracing.config import RenderConfig
    from gdpathtracing.core import rng
    pids = jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                              cam.width * cam.height)
    s = rng.prng_seed((pids % cam.width).astype(jnp.uint32),
                      (pids // cam.width).astype(jnp.uint32), jnp.uint32(0))
    ray, _ = cam.generate_rays(pids, s, RenderConfig())
    return ray


def _random_rays(scene, n, seed):
    """n incoherent rays: origins uniform in the scene's box, directions
    uniform on the sphere."""
    import jax
    import jax.numpy as jnp
    from gdpathtracing.core.vec import Vec3
    from gdpathtracing.render.types import Ray
    cb = scene.isect_chunk_bounds
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    k = jax.random.split(jax.random.PRNGKey(seed), 2)
    o = lo + (hi - lo) * jax.random.uniform(k[0], (n, 3))
    d = jax.random.normal(k[1], (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1], d[:, 2]))


def _brute(scene, ray, chunk=1 << 16):
    """trace_brute over ray chunks (bounds its (rays x 512) temporaries).
    Returns (t, inst, tri) numpy arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gdpathtracing.core.vec import Vec3
    from gdpathtracing.render.intersect import trace_brute
    from gdpathtracing.render.types import Ray
    n = ray.o.x.shape[0]
    n_pad = -(-n // chunk) * chunk

    def split(x):
        return jnp.pad(x, (0, n_pad - n)).reshape(-1, chunk)

    comps = jnp.stack([split(c) for c in (*ray.o, *ray.d)], axis=1)

    @jax.jit
    def run(comps):
        def one(c):
            h = trace_brute(scene, Ray(Vec3(c[0], c[1], c[2]),
                                       Vec3(c[3], c[4], c[5])))
            return h.t, h.inst, h.tri
        return jax.lax.map(one, comps)

    return tuple(np.asarray(a).reshape(-1)[:n] for a in run(comps))


def kernel_vs_oracle():
    """Phase 2. Tolerances: the kernel intersects in unit-triangle space
    (a per-triangle affine map precomputed in f32), the oracle runs
    Möller–Trumbore on the vertices; the two f32 formulations differ by a
    few ulp of the scene's coordinates, so t is compared to an absolute
    1e-4 x scene extent. Hit/miss and the winning (instance, triangle)
    must agree for >= 99.99% of active rays; the rest are grazing hits on
    edges and exact ties between coincident triangles."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gdpathtracing.ops.intersect_pallas import (closest_hit,
                                                    occluded_pallas,
                                                    prepare_trace_inputs)
    n = N_RAYS
    for name, (scene, cam) in _scenes().items():
        cb = np.asarray(scene.isect_chunk_bounds)
        extent = float(np.max(cb[3:6].max(axis=1) - cb[0:3].min(axis=1)))
        atol = 1e-4 * extent
        prep = jax.jit(prepare_trace_inputs)(scene)
        for kind, ray in (("camera", _camera_rays(cam, n, 1)),
                          ("random", _random_rays(scene, n - 13, 2))):
            m = ray.o.x.shape[0]
            active = jax.random.uniform(jax.random.PRNGKey(3), (m,)) < 0.9
            t, e, _ = jax.jit(closest_hit)(prep, ray, active)
            t, e = np.asarray(t), np.asarray(e)
            bt, binst, btri = _brute(scene, ray)
            act = np.asarray(active)
            bt = np.where(act, bt, 1e9)
            hk, hb = t < 1e8, bt < 1e8
            ti = np.asarray(prep.tri_inst)[np.where(hk, e, 0)]
            same_hit = hk == hb
            both = hk & hb
            same_tri = (ti[:, 0] == btri) & (ti[:, 1] == binst)
            dt = np.abs(t - bt)[both]
            frac_hit = same_hit.mean()
            frac_tri = same_tri[both].mean() if both.any() else 1.0
            frac_t = (dt <= atol).mean() if both.any() else 1.0
            # Occlusion against the oracle: tmax drawn around each ray's
            # own closest hit, so about half the rays are blocked.
            u = jax.random.uniform(jax.random.PRNGKey(4), (m,), minval=0.5,
                                   maxval=1.5)
            tmax = jnp.where(jnp.asarray(hb), jnp.asarray(bt) * u, 2 * extent)
            occ = np.asarray(jax.jit(
                lambda p, r, tm, a: occluded_pallas(None, r, tm, a, prep=p))(
                    prep, ray, tmax, active))
            occ_ref = act & (bt < np.asarray(tmax))
            bad_occ = occ != occ_ref
            near = np.abs(bt - np.asarray(tmax)) <= atol
            say("2 kernel", f"{name} {kind} n={m} active={act.sum()} "
                f"hits={hb.sum()} hit-mismatch={(~same_hit).sum()} "
                f"tri-mismatch={(~same_tri[both]).sum()} "
                f"max|dt|={dt.max() if dt.size else 0:.3g} (atol {atol:.3g}) "
                f"occluded={occ_ref.sum()} occ-mismatch={bad_occ.sum()} "
                f"(at tmax ties {(bad_occ & near).sum()})")
            check(frac_hit >= 0.9999, f"{name} {kind}: hit/miss agreement "
                  f"{frac_hit:.6f} < 0.9999")
            check(frac_tri >= 0.9999, f"{name} {kind}: triangle agreement "
                  f"{frac_tri:.6f} < 0.9999")
            check(frac_t >= 0.9999, f"{name} {kind}: t within atol "
                  f"{frac_t:.6f} < 0.9999")
            check(bad_occ.mean() <= 1e-4, f"{name} {kind}: occlusion "
                  f"mismatch {bad_occ.mean():.6f} > 1e-4")


def _timed(fn, *a, reps=3):
    """Median wall time (ms) of fn(*a) with its result on the host."""
    import jax
    jax.block_until_ready(fn(*a))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def _compare_frames(phase, got, ref):
    """Pixel-by-pixel check of a PALLAS frame against a BRUTE frame of the
    same seed. The two backends find hits by different f32 formulations
    (module docstring of kernel_vs_oracle), so a path can diverge at a
    grazing or silhouette hit: >= 99.5% of pixels must match to
    rtol = atol = 1e-3 and >= 99.9% of pixels must trace the same number
    of segments. The share that matches at tests/test_regen.py's
    1e-6 is printed too."""
    import numpy as np
    a, b = np.asarray(got.radiance), np.asarray(ref.radiance)
    check(np.isfinite(a).all(), f"{phase}: non-finite radiance")
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).all(axis=-1).mean()
    exact = np.isclose(a, b, rtol=1e-6, atol=1e-6).all(axis=-1).mean()
    sg, sr = np.asarray(got.segments), np.asarray(ref.segments)
    seg_same = (sg == sr).mean()
    say(phase, f"pixels within 1e-3 of BRUTE: {close:.5f}, within 1e-6: "
        f"{exact:.5f}; same segment count: {seg_same:.5f}; segments "
        f"{int(sg.sum())} (BRUTE {int(sr.sum())}); mean |d| "
        f"{np.abs(a - b).mean():.3g}")
    check(close >= 0.995, f"{phase}: only {close:.5f} of pixels match")
    check(seg_same >= 0.999, f"{phase}: segment counts differ on "
          f"{1 - seg_same:.5f} of pixels")
    check(sg.sum() > W * H, f"{phase}: too few segments {sg.sum()}")


def demo_frames():
    """Phases 3 and 4."""
    import jax
    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.render.renderer import render_radiance
    scene, cam = _scenes()["demo"]
    times = {}
    for phase, key, nee in (("3 demo primal", "demo_primal", False),
                            ("4 demo nee", "demo_nee", True)):
        cfg = RenderConfig(bounces=BOUNCES, spp=1, nee=nee,
                           traversal=Traversal.PALLAS)
        frame = jax.jit(lambda s, c, f, cfg=cfg: render_radiance(s, c, cfg, f))
        got = frame(scene, cam, 7)
        ref = jax.jit(lambda s, c, f, cfg=cfg: render_radiance(
            s, c, cfg.replace(traversal=Traversal.BRUTE), f))(scene, cam, 7)
        _compare_frames(phase, got, ref)
        times[key] = _timed(lambda: frame(scene, cam, 8).radiance)
    return times


def backward_step():
    """Phase 5."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.diff.inverse import image_mse, replace_albedo
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import demo_camera
    scene, cam = _scenes()["demo"]
    cfg = RenderConfig(bounces=BOUNCES, spp=1, traversal=Traversal.PALLAS,
                       differentiable=True)

    def step(cfg, cam):
        target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)

        @jax.jit
        def vg(albedo):
            return jax.value_and_grad(lambda a: image_mse(render_radiance(
                replace_albedo(scene, a), cam, cfg, 0).radiance, target))(
                    albedo)
        return vg

    vg = step(cfg, cam)
    loss, g = vg(scene.mat_albedo)
    g = np.asarray(g)
    check(np.isfinite(g).all() and np.abs(g).max() > 0,
          "5 backward: gradient not finite and non-zero")
    ms = _timed(vg, scene.mat_albedo)
    small = demo_camera(256, 256)
    gp = np.asarray(step(cfg, small)(scene.mat_albedo)[1])
    gu = np.asarray(step(cfg.replace(traversal=Traversal.UNIT), small)(
        scene.mat_albedo)[1])
    rel = np.abs(gp - gu).max() / np.abs(gu).max()
    say("5 backward", f"1080p loss={float(loss):.6g} |g|max="
        f"{np.abs(g).max():.4g}; 256^2 PALLAS vs UNIT gradient max rel "
        f"diff {rel:.3g} (limit 1e-3: both intersect in unit-triangle "
        f"space, the kernel's winners may differ on grazing hits)")
    check(rel <= 1e-3, f"5 backward: gradient differs from UNIT by {rel}")
    return {"backward": ms}


def grid_frame():
    """Phase 6: the 1080p grid frame, and the kernel's hits against
    trace_bvh (same tolerance rule as phase 2) on 2^18 camera and 2^18
    random rays."""
    import jax
    import numpy as np
    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.ops.intersect_pallas import (closest_hit,
                                                    prepare_trace_inputs)
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.render.traverse import trace_bvh
    scene, cam = _scenes()["grid"]
    cfg = RenderConfig(bounces=BOUNCES, spp=1, traversal=Traversal.PALLAS)
    frame = jax.jit(lambda s, c, f: render_radiance(s, c, cfg, f))
    aovs = frame(scene, cam, 7)
    rad, segs = np.asarray(aovs.radiance), np.asarray(aovs.segments)
    check(np.isfinite(rad).all(), "6 grid: non-finite radiance")
    check(segs.sum() > W * H, f"6 grid: too few segments {segs.sum()}")
    prep = jax.jit(prepare_trace_inputs)(scene)
    cb = np.asarray(scene.isect_chunk_bounds)
    atol = 1e-4 * float(np.max(cb[3:6].max(axis=1) - cb[0:3].min(axis=1)))
    n = N_BVH_RAYS
    msg = []
    for kind, ray in (("camera", _camera_rays(cam, n, 5)),
                      ("random", _random_rays(scene, n, 6))):
        t, e, _ = jax.jit(closest_hit)(prep, ray)
        hb = jax.jit(lambda s, r: trace_bvh(s, r))(scene, ray)
        t, bt = np.asarray(t), np.asarray(hb.t)
        hk, hbm = t < 1e8, bt < 1e8
        both = hk & hbm
        ti = np.asarray(prep.tri_inst)[np.where(hk, np.asarray(e), 0)]
        same_tri = ((ti[:, 0] == np.asarray(hb.tri))
                    & (ti[:, 1] == np.asarray(hb.inst)))[both]
        dt = np.abs(t - bt)[both]
        msg.append(f"{kind}: hits={hbm.sum()} hit-mismatch="
                   f"{(hk != hbm).sum()} tri-mismatch={(~same_tri).sum()} "
                   f"max|dt|={dt.max() if dt.size else 0:.3g}")
        check((hk == hbm).mean() >= 0.9999, f"6 grid {kind}: hit/miss")
        check(same_tri.mean() >= 0.9999, f"6 grid {kind}: triangles")
        check((dt <= atol).mean() >= 0.9999, f"6 grid {kind}: t")
    say("6 grid", f"1080p frame finite, segments {int(segs.sum())}; vs "
        f"trace_bvh (atol {atol:.3g}) " + "; ".join(msg))
    return {"grid": _timed(lambda: frame(scene, cam, 8).radiance)}


def four_cards(devices, card):
    """--four: the sharded 1080p frame and its albedo gradient over four
    cards against the one-card ones. Per-ray math is device-local, so
    radiance is expected bit-equal; the two jitted programs have other
    shapes, and XLA may fuse (and contract to FMA) differently, so the
    check allows rtol = 1e-6 and reports whether it is bit-equal. The
    gradient is held to rtol 1e-6: the psum over cards reorders the sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gdpathtracing.config import RenderConfig, Traversal
    from gdpathtracing.diff.inverse import image_mse, replace_albedo
    from gdpathtracing.parallel.sharding import (make_mesh,
                                                 render_radiance_sharded)
    from gdpathtracing.render.renderer import render_radiance
    scene, cam = _scenes()["demo"]
    mesh = make_mesh(devices)
    cfg = RenderConfig(bounces=BOUNCES, spp=1, traversal=Traversal.PALLAS,
                       regen=False)
    one = jax.jit(lambda f: render_radiance(scene, cam, cfg, f))
    four = jax.jit(lambda f: render_radiance_sharded(scene, cam, cfg, f,
                                                     mesh))
    a, b = np.asarray(one(3).radiance), np.asarray(four(3).radiance)
    check(np.isfinite(b).all(), "four: non-finite radiance")
    say("four frame", f"{W}x{H} sharded over {len(devices)} cards vs one: "
        f"bit-equal={np.array_equal(a, b)} max|d|={np.abs(a - b).max():.3g}"
        f"; ms/frame one={_timed(lambda: one(4).radiance):.3f} four="
        f"{_timed(lambda: four(4).radiance):.3f} on {card}")
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    dcfg = cfg.replace(differentiable=True)
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)

    def loss(render):
        return lambda alb: image_mse(render(replace_albedo(scene, alb))
                                     .radiance, target)

    g1 = np.asarray(jax.jit(jax.grad(loss(
        lambda s: render_radiance(s, cam, dcfg, 3))))(scene.mat_albedo))
    g4 = np.asarray(jax.jit(jax.grad(loss(
        lambda s: render_radiance_sharded(s, cam, dcfg, 3, mesh))))(
            scene.mat_albedo))
    rel = np.abs(g4 - g1).max() / np.abs(g1).max()
    say("four grad", f"albedo gradient four vs one card: max rel diff "
        f"{rel:.3g}")
    check(np.isfinite(g4).all() and np.abs(g4).max() > 0,
          "four: gradient not finite and non-zero")
    np.testing.assert_allclose(g4, g1, rtol=1e-6, atol=1e-6 * np.abs(
        g1).max())


if __name__ == "__main__":
    sys.exit(main())
