"""BRDF correctness (SURVEY.md §4d): pdf normalization via Monte Carlo,
sampling/eval consistency (white furnace), energy conservation."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.core.vec import Vec3
from gdpathtracing.render import brdf
from gdpathtracing.render.types import ShadingInfo

N = 200_000


def _shading(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=0.5,
             view=(0.0, 0.3, 1.0), n=N):
    normal = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.ones(n))
    v = np.asarray(view, np.float32)
    v /= np.linalg.norm(v)
    out_dir = Vec3(jnp.full(n, v[0]), jnp.full(n, v[1]), jnp.full(n, v[2]))
    alb = Vec3(jnp.full(n, albedo[0]), jnp.full(n, albedo[1]),
               jnp.full(n, albedo[2]))
    f0 = Vec3.full(0.02, like=alb) + (alb - Vec3.full(0.02, like=alb)) * metallic
    diffuse = alb - alb * metallic
    return ShadingInfo(
        position=Vec3.full(0.0, like=alb),
        normal=normal,
        out_dir=out_dir,
        lambert_out=normal.dot(out_dir),
        emission=Vec3.full(0.0, like=alb),
        diffuse_albedo=diffuse,
        fresnel_0=f0,
        roughness=jnp.full(n, roughness),
        transmission=jnp.zeros(n),
        ior=jnp.full(n, 1.5),
        albedo=alb,
    )


def _rand(n, seed):
    rs = np.random.RandomState(seed)
    return (jnp.asarray(rs.uniform(size=n).astype(np.float32)),
            jnp.asarray(rs.uniform(size=n).astype(np.float32)))


def test_sampled_directions_unit_and_pdf_positive():
    s = _shading(roughness=0.3, metallic=0.5)
    r1, r2 = _rand(N, 0)
    d = brdf.sample_brdf(s, r1, r2)
    lens = np.asarray(d.length())
    assert np.allclose(lens, 1.0, atol=1e-3)
    pdf = np.asarray(brdf.brdf_pdf(s, d))
    up = np.asarray(d.z) > 1e-3
    assert (pdf[up] > 0).mean() > 0.999


def test_pdf_integrates_to_one():
    """∫ pdf dω = 1 over the FULL sphere, estimated with uniform sphere
    sampling. (The VNDF reflection lobe carries mass below the horizon —
    the integrator terminates those paths via the lambert_in ≤ 0 check,
    main.glsl:390-392 — so the sphere, not the hemisphere, is the correct
    normalization domain.)"""
    for metallic, roughness in [(0.0, 1.0), (1.0, 0.3), (0.5, 0.6)]:
        s = _shading(metallic=metallic, roughness=roughness)
        rs = np.random.RandomState(7)
        d = rs.normal(size=(N, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dirs = Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]),
                    jnp.asarray(d[:, 2]))
        pdf = np.asarray(brdf.brdf_pdf(s, dirs))
        # uniform sphere density = 1/(4π)
        integral = pdf.mean() * 4 * np.pi
        assert abs(integral - 1.0) < 0.05, (metallic, roughness, integral)


def test_white_furnace_diffuse():
    """E[f·cosθ/pdf] ≈ albedo for a white diffuse surface: the directional
    albedo of the full BRDF under its own sampling must be ≤1 and near 1
    (energy conservation; SURVEY.md §4d)."""
    s = _shading(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=1.0)
    r1, r2 = _rand(N, 3)
    d = brdf.sample_brdf(s, r1, r2)
    pdf = np.asarray(brdf.brdf_pdf(s, d))
    cos = np.asarray(s.normal.dot(d))
    f = np.asarray(brdf.eval_brdf(s, d).x)
    ok = (cos > 0) & (pdf > 1e-9)
    est = np.where(ok, f * cos / np.maximum(pdf, 1e-9), 0.0)
    mean = est.mean()
    # Diffuse Burley with retro term is not exactly 1 but must be close
    # and never blow up.
    assert 0.85 < mean < 1.1, mean
    assert est.max() < 50.0


def test_metal_furnace_bounded():
    s = _shading(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.2)
    r1, r2 = _rand(N, 4)
    d = brdf.sample_brdf(s, r1, r2)
    pdf = np.asarray(brdf.brdf_pdf(s, d))
    cos = np.asarray(s.normal.dot(d))
    f = np.asarray(brdf.eval_brdf(s, d).x)
    ok = (cos > 0) & (pdf > 1e-9)
    est = np.where(ok, f * cos / np.maximum(pdf, 1e-9), 0.0)
    mean = est.mean()
    assert 0.6 < mean <= 1.05, mean  # mirror metal: high but ≤ 1 reflectance


def test_eval_brdf_zero_below_horizon():
    s = _shading()
    below = Vec3(jnp.zeros(N), jnp.zeros(N), -jnp.ones(N))
    f = brdf.eval_brdf(s, below)
    assert np.allclose(np.asarray(f.x), 0.0)


def test_shading_frame_orthonormal():
    rs = np.random.RandomState(9)
    n = rs.normal(size=(1000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    nv = Vec3(jnp.asarray(n[:, 0]), jnp.asarray(n[:, 1]), jnp.asarray(n[:, 2]))
    t, b = brdf.shading_frame(nv)
    assert np.allclose(np.asarray(t.length()), 1.0, atol=1e-5)
    assert np.allclose(np.asarray(b.length()), 1.0, atol=1e-5)
    assert np.allclose(np.asarray(t.dot(b)), 0.0, atol=1e-5)
    assert np.allclose(np.asarray(t.dot(nv)), 0.0, atol=1e-5)
    assert np.allclose(np.asarray(b.dot(nv)), 0.0, atol=1e-5)
    # Right-handed: t × b = n
    c = t.cross(b)
    assert np.allclose(np.asarray(c.to_array()), n, atol=1e-5)
