"""The Pallas trace kernel (ops/intersect_pallas.py) in interpret mode
against the brute-force oracle, its wrapper (padding, parking, queue,
epilogue), and the entry points around it: interpret-mode choice, the
compile-cache rule, bench.py's failure exit and chip_smoke.py's refusal
without a GPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gdpathtracing.ops.intersect_pallas as ip
from gdpathtracing.config import RenderConfig
from gdpathtracing.core import rng
from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.intersect import trace_brute
from gdpathtracing.render.types import Ray
from gdpathtracing.scene.demo import (build_demo_scene, build_sphere_grid,
                                      demo_camera, grid_camera)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def scenes():
    """flat: one superchunk of several chunks; superchunk: several."""
    return {
        "flat": (build_demo_scene(texture_resolution=8, sphere_detail=16,
                                  geometry="sphere"), demo_camera(16, 12)),
        "superchunk": (build_sphere_grid(n=4, sphere_detail=12),
                       grid_camera(16, 12, n=4)),
    }


def _random_rays(scene, n, seed):
    rs = np.random.RandomState(seed)
    cb = np.asarray(scene.isect_chunk_bounds)
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = (lo + (hi - lo) * rs.uniform(size=(n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))


def _camera_rays(cam):
    pids = jnp.arange(cam.width * cam.height, dtype=jnp.int32)
    s = rng.prng_seed((pids % cam.width).astype(jnp.uint32),
                      (pids // cam.width).astype(jnp.uint32), jnp.uint32(0))
    return cam.generate_rays(pids, s, RenderConfig())[0]


def _rays(kind, scene, cam):
    """(ray, active) for one case of the closest-hit grid."""
    if kind == "camera":  # 192 coherent rays: a whole number of blocks
        return _camera_rays(cam), None
    if kind == "incoherent":
        return _random_rays(scene, 256, 1), None
    if kind == "active":
        ray = _random_rays(scene, 256, 2)
        return ray, jnp.asarray(np.random.RandomState(3).uniform(
            size=256) < 0.6)
    assert kind == "ragged"  # not a multiple of the ray block
    assert 301 % ip.BN
    return _random_rays(scene, 301, 4), None


def _tri_inst(prep, eidx):
    return np.asarray(prep.tri_inst)[np.asarray(eidx)]


@pytest.mark.parametrize("kind", ["camera", "incoherent", "active",
                                  "ragged"])
@pytest.mark.parametrize("which", ["flat", "superchunk"])
def test_closest_hit_matches_brute(scenes, which, kind):
    scene, cam = scenes[which]
    ray, active = _rays(kind, scene, cam)
    prep = ip.prepare_trace_inputs(scene)
    t, eidx, steps = ip.closest_hit(prep, ray, active)
    ref = trace_brute(scene, ray, active)
    t, bt = np.asarray(t), np.asarray(ref.t)
    assert t.shape == bt.shape == (ray.o.x.shape[0],)
    hit = bt < 1e8
    np.testing.assert_array_equal(t < 1e8, hit)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-4, atol=1e-4)
    ti = _tri_inst(prep, eidx)
    np.testing.assert_array_equal(ti[hit, 0], np.asarray(ref.tri)[hit])
    np.testing.assert_array_equal(ti[hit, 1], np.asarray(ref.inst)[hit])
    if active is not None:  # parked rays sweep nothing
        assert (np.asarray(steps)[~np.asarray(active)] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("which", ["flat", "superchunk"])
def test_occlusion_matches_brute(scenes, which, masked):
    scene, _ = scenes[which]
    ray = _random_rays(scene, 256, 5)
    ref_t = np.asarray(trace_brute(scene, ray).t)
    # tmax around each ray's own closest hit: about half are blocked.
    u = np.random.RandomState(6).uniform(0.5, 1.5, size=256)
    tmax = np.where(ref_t < 1e8, ref_t * u, 50.0).astype(np.float32)
    active = (jnp.asarray(np.random.RandomState(7).uniform(size=256) < 0.7)
              if masked else None)
    occ = np.asarray(ip.occluded_pallas(scene, ray, jnp.asarray(tmax),
                                        active))
    expect = ref_t < tmax
    if masked:
        expect &= np.asarray(active)
    assert 0 < expect.sum() < 256
    np.testing.assert_array_equal(occ, expect)


@pytest.mark.parametrize("copies", [2, 200])
def test_tie_rule_takes_lowest_eidx(copies):
    """Coincident copies of one quad are hit at exactly the same t: the
    winner is the lowest expanded index among them — across the tiles of
    a chunk, and with 200 copies (400 triangles) across chunks too."""
    from gdpathtracing.scene.materials import Material
    from gdpathtracing.scene.primitives import plane_mesh
    from gdpathtracing.scene.scene import SceneBuilder
    b = SceneBuilder()
    quad = b.add_mesh(plane_mesh(size=2.0))
    for _ in range(copies):
        b.add_instance(quad, np.eye(4, dtype=np.float32)[:3],
                       materials=[Material()])
    scene = b.build()
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.linspace(-0.9, 0.9, n)
    o[:, 1] = 1.0
    o[:, 2] = np.linspace(0.8, -0.8, n)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    ray = Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))
    prep = ip.prepare_trace_inputs(scene)
    t, eidx, _ = ip.closest_hit(prep, ray)
    np.testing.assert_allclose(np.asarray(t), 1.0, rtol=1e-6)
    tri = np.asarray(scene.isect_tri)[: 2 * copies]
    e = np.asarray(eidx)
    for k in range(n):
        assert e[k] == np.nonzero(tri == tri[e[k]])[0].min(), k
    if copies == 200:
        assert scene.isect_mu.shape[1] // ip.CHUNK >= 2


@pytest.mark.parametrize("which", ["flat", "superchunk"])
def test_epilogue_matches_brute(scenes, which):
    """u/v/front/tri/inst of trace_pallas (kernel winner + XLA epilogue)
    and of trace_pallas_diff (recomputed t) against the oracle."""
    scene, _ = scenes[which]
    ray = _random_rays(scene, 200, 8)
    ref = trace_brute(scene, ray)
    hit = np.asarray(ref.t) < 1e8
    for got in (ip.trace_pallas(scene, ray), ip.trace_pallas_diff(scene, ray)):
        np.testing.assert_allclose(np.asarray(got.t)[hit],
                                   np.asarray(ref.t)[hit], rtol=1e-4,
                                   atol=1e-4)
        for f in ("tri", "inst", "front"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f))[hit],
                                          np.asarray(getattr(ref, f))[hit])
        for f in ("u", "v"):
            np.testing.assert_allclose(np.asarray(getattr(got, f))[hit],
                                       np.asarray(getattr(ref, f))[hit],
                                       atol=2e-3)


def test_queue_is_conservative(scenes):
    """Every superchunk that holds a ray's hit is among the candidates
    of that ray's block queue."""
    scene, _ = scenes["superchunk"]
    ray = _random_rays(scene, 256, 9)
    prep = ip.prepare_trace_inputs(scene)
    rays = ip._pack_rays(ray, None, None)
    queue, count = ip._block_queue(rays, prep.sb)
    queue, count = np.asarray(queue), np.asarray(count)
    t, eidx, _ = ip.closest_hit(prep, ray)
    sc = np.asarray(eidx) // (ip.CHUNK * ip.SCC)
    for r in np.nonzero(np.asarray(t) < 1e8)[0]:
        blk = r // ip.BN
        assert sc[r] in queue[blk, :count[blk]], r


def test_pack_rays_pads_and_parks():
    ray = Ray(Vec3.from_array(jnp.ones((5, 3))),
              Vec3.from_array(jnp.ones((5, 3))))
    active = jnp.asarray([True, False, True, True, False])
    rows = np.asarray(ip._pack_rays(ray, active, jnp.full((5,), 2.0)))
    assert rows.shape == (8, ip.BN)
    np.testing.assert_array_equal(rows[6, :5], [2.0, 0.0, 2.0, 2.0, 0.0])
    parked = np.r_[[False, True, False, False, True],
                   np.ones(ip.BN - 5, bool)]
    assert (rows[0:3, parked] == 1e9).all()
    assert (rows[6, 5:] == 0.0).all()


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False)])
def test_interpret_mode_follows_platform(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert ip._interpret() is expect


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from gdpathtracing.utils import compile_cache
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == old  # untouched
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_bench_exits_nonzero_when_an_axis_fails(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    import bench
    # An axis whose subprocess fails at argument parsing (no JAX needed).
    monkeypatch.setattr(bench, "AXES", {"primal": (["--width", "x"], 60)})
    assert bench.run_all_axes(verbose=False) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line, no nulls
    assert "FAILED primal" in out.err


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_result_line_format():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
