"""Differentiable soft-shadow visibility (render/intersect.occlusion_soft):
forward consistency with hard shadows, and silhouette gradients w.r.t. a
BLOCKER's transform that finite differences confirm — the boundary term
the hard-visibility estimator drops (SURVEY.md §7 step 6, hard part #2)."""

import jax
import jax.numpy as jnp
import numpy as np

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


def _build():
    b = SceneBuilder()
    floor = b.add_mesh(plane_mesh(size=8.0))
    light = b.add_mesh(plane_mesh(size=2.0))
    blocker = b.add_mesh(plane_mesh(size=1.2))
    b.add_instance(floor, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 0, 0)),
                   materials=[Material(albedo=(0.8, 0.8, 0.8),
                                       roughness=0.8)])
    # light faces down (flip Y)
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


def _cfg(soft):
    return RenderConfig(bounces=1, spp=2, nee=True, jitter=Jitter.NONE,
                        traversal=Traversal.UNIT, soft_shadows=soft)


def _render_tx(scene, cam, tx, soft):
    base = scene.inst_transform
    delta = jnp.zeros_like(base).at[2, 0, 3].set(tx)  # blocker x offset
    s = update_instance_transforms(scene, base + delta)
    return render_radiance(s, cam, _cfg(soft), 0).radiance


def test_soft_matches_hard_for_small_eps():
    scene, cam = _build()
    hard = np.asarray(_render_tx(scene, cam, 0.0, 0.0))
    soft = np.asarray(_render_tx(scene, cam, 0.0, 1e-4))
    assert np.isfinite(soft).all()
    assert np.abs(soft - hard).mean() < 0.01, np.abs(soft - hard).mean()
    # the shadow actually exists: some floor pixels are much darker
    assert hard.std() > 0.05


def test_blocker_translation_gradient_matches_fd():
    scene, cam = _build()
    eps_edge = 0.05
    target = jax.lax.stop_gradient(_render_tx(scene, cam, 0.4, eps_edge))

    def loss(tx):
        img = _render_tx(scene, cam, tx, eps_edge)
        return jnp.mean((img - target) ** 2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    # moving the blocker toward the target (+x) must reduce the loss
    assert g < 0.0, g
    h = 0.05
    fd = (float(loss(jnp.float32(h))) - float(loss(jnp.float32(-h)))) / (2 * h)
    assert fd < 0.0, fd
    assert abs(g - fd) / abs(fd) < 0.5, (g, fd)


def test_hard_visibility_has_no_blocker_gradient():
    """Control: with hard shadows the silhouette gradient is exactly the
    term we're adding — grad w.r.t. the blocker offset is ~0 (the blocker
    is dark and mostly affects the image through its shadow)."""
    scene, cam = _build()
    target = jax.lax.stop_gradient(_render_tx(scene, cam, 0.4, 0.05))

    def loss_hard(tx):
        img = _render_tx(scene, cam, tx, 0.0)
        return jnp.mean((img - target) ** 2)

    g_hard = float(jax.grad(loss_hard)(jnp.float32(0.0)))
    def loss_soft(tx):
        img = _render_tx(scene, cam, tx, 0.05)
        return jnp.mean((img - target) ** 2)
    g_soft = float(jax.grad(loss_soft)(jnp.float32(0.0)))
    assert abs(g_soft) > 5.0 * abs(g_hard) + 1e-12, (g_soft, g_hard)
