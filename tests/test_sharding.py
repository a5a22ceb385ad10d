"""Multi-chip tests on the virtual 8-device CPU mesh (SURVEY.md §4f):
sharded render == single-device render bit-for-bit; graft entry dryrun."""

import numpy as np
import jax

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.parallel.sharding import (make_mesh,
                                                 render_radiance_sharded)
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_cornell_simple, demo_camera


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device_bitwise():
    scene = build_cornell_simple()
    cam = demo_camera(40, 24)  # 960 px, not divisible by 8 evenly in w
    cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.BRUTE,
                       jitter=Jitter.UNIFORM)
    single = render_radiance(scene, cam, cfg, frame_index=3)
    mesh = make_mesh(jax.devices())
    sharded = render_radiance_sharded(scene, cam, cfg, 3, mesh)
    a = np.asarray(single.radiance)
    b = np.asarray(sharded.radiance)
    # Same per-pixel RNG streams (keyed by pixel+frame, not chip) → the
    # sharded image must match the single-device one bit-for-bit.
    assert np.array_equal(a, b), np.abs(a - b).max()
    assert np.array_equal(np.asarray(single.depth), np.asarray(sharded.depth))


def test_sharded_pallas_interpret_bitwise():
    """The flagship PALLAS backend under shard_map (kernel in interpret
    mode on the CPU mesh) must bit-match the single-device
    render — nee off and on (the NEE path adds the any-hit occlusion kernel
    to the sharded program)."""
    scene = build_cornell_simple()
    cam = demo_camera(40, 24)
    mesh = make_mesh(jax.devices())
    for nee in (False, True):
        # regen=False on the single side: the sharded path runs the
        # standard per-bounce loop, and the bit-equality contract is
        # like-for-like (regen reproduces the same per-path transport
        # but different BLOCK composition, so traversal tie-breaks can
        # flip — checked separately below at allclose).
        cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                           tile_rays=1024, nee=nee, regen=False)
        single = render_radiance(scene, cam, cfg, frame_index=3)
        sharded = render_radiance_sharded(scene, cam, cfg, 3, mesh)
        a = np.asarray(single.radiance)
        b = np.asarray(sharded.radiance)
        assert np.array_equal(a, b), (nee, np.abs(a - b).max())
        regen = render_radiance(scene, cam, cfg.replace(regen=True),
                                frame_index=3)
        np.testing.assert_allclose(np.asarray(regen.radiance), a,
                                   rtol=1e-5, atol=1e-5)


def test_sharded_pallas_grad_matches_single():
    """Gradient of a sharded differentiable-PALLAS render w.r.t. the
    replicated albedo table: the shard_map transpose inserts the psum over
    chips; must match the single-device gradient."""
    import jax.numpy as jnp
    from gdpathtracing.diff.inverse import image_mse, replace_albedo
    scene = build_cornell_simple()
    cam = demo_camera(40, 24)
    mesh = make_mesh(jax.devices())
    cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                       tile_rays=1024, differentiable=True)
    target = jnp.zeros((24, 40, 3), jnp.float32)

    def loss_sharded(albedo):
        s = replace_albedo(scene, albedo)
        aovs = render_radiance_sharded(s, cam, cfg, 0, mesh)
        return image_mse(aovs.radiance, target)

    def loss_single(albedo):
        s = replace_albedo(scene, albedo)
        return image_mse(render_radiance(s, cam, cfg, 0).radiance, target)

    g_sh = np.asarray(jax.grad(loss_sharded)(scene.mat_albedo))
    g_1 = np.asarray(jax.grad(loss_single)(scene.mat_albedo))
    assert np.allclose(g_sh, g_1, rtol=1e-5, atol=1e-7), \
        np.abs(g_sh - g_1).max()


def test_sharded_odd_sizes():
    scene = build_cornell_simple()
    cam = demo_camera(13, 7)  # 91 px: forces padding
    cfg = RenderConfig(bounces=1, spp=1, traversal=Traversal.BRUTE)
    mesh = make_mesh(jax.devices())
    sharded = render_radiance_sharded(scene, cam, cfg, 0, mesh)
    single = render_radiance(scene, cam, cfg, 0)
    assert np.array_equal(np.asarray(single.radiance),
                          np.asarray(sharded.radiance))


def test_graft_entry_and_dryrun():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        pathlib.Path(__file__).resolve().parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    assert np.isfinite(np.asarray(out)).all()

    mod.dryrun_multichip(8)
