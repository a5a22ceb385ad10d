"""NEE + MIS: same expected image as BRDF-only transport, lower variance."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_cornell_simple, demo_camera

BASE = RenderConfig(bounces=2, spp=8, traversal=Traversal.UNIT,
                    jitter=Jitter.NONE)
RES = 32


def _mean_images():
    scene = build_cornell_simple()
    cam = demo_camera(RES, RES)
    imgs = {}
    for nee in (False, True):
        cfg = BASE.replace(nee=nee)
        acc = None
        frames = 3
        for f in range(frames):
            r = np.asarray(render_radiance(scene, cam, cfg, f).radiance)
            acc = r if acc is None else acc + r
        imgs[nee] = acc / frames
    return imgs


def test_scene_light_table():
    scene = build_cornell_simple()
    assert scene.n_lights == 2  # the emissive plane's two triangles
    from gdpathtracing.render.lights import build_light_table
    t = build_light_table(scene)
    area = np.asarray(t.area)
    assert np.allclose(area, 2.0, atol=1e-4)  # 2x2 plane → 2 tris of area 2
    assert np.allclose(np.asarray(t.cdf)[-1], 1.0, atol=1e-5)
    em = np.asarray(t.emission.to_array())
    assert (em > 5).all()  # energy 10


def test_nee_matches_brdf_expectation_with_less_noise():
    imgs = _mean_images()
    off, on = imgs[False], imgs[True]
    assert np.isfinite(on).all()
    # Compare means over the interior region (both are MC estimates of the
    # same integral; 64 samples each → few-percent agreement on averages).
    c = RES // 2
    box = (slice(c - 8, c + 8), slice(c - 8, c + 8))
    m_off = off[box].mean()
    m_on = on[box].mean()
    assert abs(m_on - m_off) / m_off < 0.15, (m_on, m_off)

    # Variance: per-pixel spread across 1-spp frames.
    scene = build_cornell_simple()
    cam = demo_camera(RES, RES)

    def frames(nee, n=4):
        cfg = BASE.replace(nee=nee, spp=1)
        return np.stack([
            np.asarray(render_radiance(scene, cam, cfg, 100 + f).radiance)
            for f in range(n)])

    var_off = frames(False).var(axis=0)[box].mean()
    var_on = frames(True).var(axis=0)[box].mean()
    assert var_on < 0.5 * var_off, (var_on, var_off)
