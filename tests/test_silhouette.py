"""Silhouette (visibility-discontinuity) gradients on the PALLAS fast
path: soft-shadow visibility (the all-triangle product of
intersect.occlusion_soft) and primary-hit silhouettes via the soft-primary
relaxation — both FD-verified w.r.t. an instance translation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.dynamic import update_instance_transforms
from gdpathtracing.scene.materials import Material
from gdpathtracing.scene.primitives import plane_mesh
from gdpathtracing.scene.scene import SceneBuilder


def _affine(rows, origin):
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.asarray(rows, np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


# ---- soft shadows through PALLAS ----

def _shadow_scene():
    b = SceneBuilder()
    floor = b.add_mesh(plane_mesh(size=8.0))
    light = b.add_mesh(plane_mesh(size=2.0))
    blocker = b.add_mesh(plane_mesh(size=1.2))
    b.add_instance(floor, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 0, 0)),
                   materials=[Material(albedo=(0.8, 0.8, 0.8),
                                       roughness=0.8)])
    b.add_instance(light, _affine([1, 0, 0, 0, -1, 0, 0, 0, -1], (0, 4, 0)),
                   materials=[Material(emission=(1, 1, 1),
                                       emission_energy=10.0)])
    b.add_instance(blocker, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 2, 0)),
                   materials=[Material(albedo=(0.2, 0.2, 0.2),
                                       roughness=0.8)])
    scene = b.build()
    cam = Camera.looking_at((0.0, 3.0, 5.0), (0.0, 0.0, 0.0),
                            fov_deg=50.0, width=32, height=32)
    return scene, cam


def _render_shadow(scene, cam, tx, traversal, soft):
    base = scene.inst_transform
    delta = jnp.zeros_like(base).at[2, 0, 3].set(tx)
    s = update_instance_transforms(scene, base + delta)
    cfg = RenderConfig(bounces=1, spp=2, nee=True, jitter=Jitter.NONE,
                       traversal=traversal, soft_shadows=soft,
                       differentiable=(traversal == Traversal.PALLAS))
    return render_radiance(s, cam, cfg, 0).radiance


def test_pallas_soft_shadow_matches_unit_product():
    # PALLAS soft shadows take the same all-triangle product as UNIT;
    # only the differentiable recompute of the hits differs.
    scene, cam = _shadow_scene()
    a = np.asarray(_render_shadow(scene, cam, 0.1, Traversal.UNIT, 0.03))
    b = np.asarray(_render_shadow(scene, cam, 0.1, Traversal.PALLAS, 0.03))
    assert np.isfinite(b).all()
    assert np.abs(a - b).mean() < 5e-3, np.abs(a - b).mean()


def test_pallas_soft_shadow_gradient_matches_fd():
    scene, cam = _shadow_scene()
    eps_edge = 0.05
    target = jax.lax.stop_gradient(
        _render_shadow(scene, cam, 0.4, Traversal.PALLAS, eps_edge))

    def loss(tx):
        img = _render_shadow(scene, cam, tx, Traversal.PALLAS, eps_edge)
        return jnp.mean((img - target) ** 2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    assert g < 0.0, g
    h = 0.05
    fd = (float(loss(jnp.float32(h)))
          - float(loss(jnp.float32(-h)))) / (2 * h)
    assert fd < 0.0, fd
    assert abs(g - fd) / abs(fd) < 0.5, (g, fd)


# ---- primary-hit silhouettes (soft_primary) ----

def _primary_scene():
    b = SceneBuilder()
    card = b.add_mesh(plane_mesh(size=1.5))
    # An emissive card floating in the sky, facing the camera (+z).
    b.add_instance(card, _affine([1, 0, 0, 0, 0, -1, 0, 1, 0], (0, 1, 0)),
                   materials=[Material(albedo=(1, 1, 1),
                                       emission=(2.0, 0.5, 0.2),
                                       emission_energy=2.0)])
    scene = b.build()
    cam = Camera.looking_at((0.0, 1.0, 4.0), (0.0, 1.0, 0.0),
                            fov_deg=45.0, width=32, height=32)
    return scene, cam


def _render_primary(scene, cam, tx, traversal, soft):
    base = scene.inst_transform
    delta = jnp.zeros_like(base).at[0, 0, 3].set(tx)
    s = update_instance_transforms(scene, base + delta)
    cfg = RenderConfig(bounces=1, spp=1, jitter=Jitter.NONE,
                       traversal=traversal, soft_primary=soft,
                       differentiable=(traversal == Traversal.PALLAS))
    return render_radiance(s, cam, cfg, 0).radiance


@pytest.mark.parametrize("traversal", [Traversal.BRUTE, Traversal.PALLAS])
def test_soft_primary_gradient_matches_fd(traversal):
    scene, cam = _primary_scene()
    eps_edge = 0.05
    target = jax.lax.stop_gradient(
        _render_primary(scene, cam, 0.3, traversal, eps_edge))

    def loss(tx):
        img = _render_primary(scene, cam, tx, traversal, eps_edge)
        return jnp.mean((img - target) ** 2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    assert g < 0.0, g  # moving toward the target reduces the loss
    h = 0.04
    fd = (float(loss(jnp.float32(h)))
          - float(loss(jnp.float32(-h)))) / (2 * h)
    assert fd < 0.0, fd
    assert abs(g - fd) / abs(fd) < 0.5, (g, fd)


def test_soft_primary_zero_eps_is_hard():
    scene, cam = _primary_scene()
    hard = np.asarray(_render_primary(scene, cam, 0.0, Traversal.BRUTE,
                                      0.0))
    soft = np.asarray(_render_primary(scene, cam, 0.0, Traversal.BRUTE,
                                      1e-5))
    assert np.abs(hard - soft).mean() < 1e-3


def test_hard_primary_has_no_silhouette_gradient():
    """Control: without the relaxation, the object-over-sky boundary term
    is absent from the gradient."""
    scene, cam = _primary_scene()
    target = jax.lax.stop_gradient(
        _render_primary(scene, cam, 0.3, Traversal.BRUTE, 0.05))

    def loss(tx, soft):
        img = _render_primary(scene, cam, tx, Traversal.BRUTE, soft)
        return jnp.mean((img - target) ** 2)

    g_hard = float(jax.grad(lambda t: loss(t, 0.0))(jnp.float32(0.0)))
    g_soft = float(jax.grad(lambda t: loss(t, 0.05))(jnp.float32(0.0)))
    assert abs(g_soft) > 5.0 * abs(g_hard) + 1e-12, (g_soft, g_hard)
