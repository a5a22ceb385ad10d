"""Golden-image regression: fixed-seed low-res renders must stay stable
(guards against silent light-transport changes). Four goldens pin the
paths most at risk during perf surgery:

  cornell_16  — BRUTE oracle transport (the original round-1 golden)
  pallas_16   — PALLAS kernel numerics end-to-end (interpret mode)
  nee_16      — NEE + MIS transport (UNIT backend)
  glass_16    — dielectric transmission (UNIT backend)

Regenerate with `python tests/test_golden.py` ONLY after INTENTIONAL
transport changes (document the reason in the commit message)."""

from pathlib import Path

import numpy as np
import pytest

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import (build_cornell_simple,
                                          build_demo_scene, demo_camera)

DATA = Path(__file__).parent / "data"


def _glass_scene():
    from gdpathtracing.scene.materials import Material
    from gdpathtracing.scene.primitives import uv_sphere
    from gdpathtracing.scene.demo import (BOX_GREEN, BOX_GREY, BOX_RED,
                                              LIGHT_MAT, _affine)
    from gdpathtracing.scene.primitives import cornell_box, plane_mesh
    from gdpathtracing.scene.scene import SceneBuilder
    glass = Material(albedo=(1.0, 0.9, 0.9), transmission=1.0, ior=1.5,
                     roughness=0.05)
    b = SceneBuilder()
    light_mesh = b.add_mesh(plane_mesh(size=2.0))
    box_mesh = b.add_mesh(cornell_box(size=5.0))
    sphere = b.add_mesh(uv_sphere(radius=1.2, rings=8, segments=16))
    b.add_instance(light_mesh,
                   _affine([1, 0, 0, 0, -1, 0, 0, 0, -1], (0, 2.95581, 0)),
                   materials=[LIGHT_MAT])
    b.add_instance(box_mesh,
                   _affine([-2.6e-08, 0, -0.6, 0, 0.6, 0, 0.6, 0, -2.6e-08],
                           (0, 0, 0)),
                   materials=[BOX_GREY, BOX_RED, BOX_GREEN])
    b.add_instance(sphere, np.eye(4, dtype=np.float32)[:3],
                   materials=[glass])
    return b.build()


CASES = {
    "cornell_16": dict(
        scene=build_cornell_simple,
        config=RenderConfig(bounces=3, spp=4, traversal=Traversal.BRUTE,
                            jitter=Jitter.NONE),
        file="golden_cornell_16.npz"),
    "pallas_16": dict(
        scene=lambda: build_demo_scene(texture_resolution=8,
                                       sphere_detail=6),
        config=RenderConfig(bounces=3, spp=2, traversal=Traversal.PALLAS,
                            jitter=Jitter.NONE),
        file="golden_pallas_16.npz"),
    "nee_16": dict(
        scene=lambda: build_demo_scene(texture_resolution=8,
                                       sphere_detail=6),
        config=RenderConfig(bounces=3, spp=2, traversal=Traversal.UNIT,
                            nee=True, jitter=Jitter.NONE),
        file="golden_nee_16.npz"),
    "glass_16": dict(
        scene=_glass_scene,
        config=RenderConfig(bounces=4, spp=2, traversal=Traversal.UNIT,
                            jitter=Jitter.NONE),
        file="golden_glass_16.npz"),
}


def _render(case):
    scene = case["scene"]()
    cam = demo_camera(16, 16)
    return np.asarray(render_radiance(scene, cam, case["config"], 0).radiance)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    case = CASES[name]
    golden = DATA / case["file"]
    img = _render(case)
    if not golden.exists():
        raise AssertionError(f"golden {golden} missing — run this module "
                             f"as a script to generate it")
    ref = np.load(golden)["image"]
    # CPU float math is deterministic given fixed seeds; allow tiny
    # cross-backend wiggle.
    assert np.allclose(img, ref, rtol=2e-3, atol=2e-3), \
        (name, float(np.abs(img - ref).max()))


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    DATA.mkdir(parents=True, exist_ok=True)
    for name, case in sorted(CASES.items()):
        golden = DATA / case["file"]
        if golden.exists():
            print(f"keep existing {golden} (delete to regenerate)")
            continue
        np.savez_compressed(golden, image=_render(case))
        print(f"wrote {golden}")
