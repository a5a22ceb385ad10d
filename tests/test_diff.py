"""Differentiable rendering (SURVEY.md §4e): finite-difference checks for
albedo/emission gradients (interior derivatives — exact), smoke checks for
vertex and camera gradients (silhouette bias expected, finiteness +
nonzeroness asserted)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from gdpathtracing.config import Jitter, RenderConfig, Traversal
from gdpathtracing.diff.inverse import (render_loss, replace_albedo,
                                            replace_camera_transform,
                                            replace_emission,
                                            replace_vertices)
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_cornell_simple, demo_camera

CFG = RenderConfig(bounces=2, spp=1, traversal=Traversal.BRUTE,
                   jitter=Jitter.NONE)
RES = 24


def _mean_radiance(scene, cam):
    return jnp.mean(render_radiance(scene, cam, CFG, 0).radiance)


def test_albedo_gradient_matches_fd():
    scene = build_cornell_simple()
    cam = demo_camera(RES, RES)
    albedo0 = scene.mat_albedo

    def f(albedo):
        return _mean_radiance(replace_albedo(scene, albedo), cam)

    g = jax.grad(f)(albedo0)
    g = np.asarray(g)
    assert np.isfinite(g).all()

    # Central differences on a few components with nonzero gradient.
    eps = 1e-3
    checked = 0
    mats = np.argsort(-np.abs(g).sum(axis=1))[:3]
    for m in mats:
        for c in range(3):
            if abs(g[m, c]) < 1e-5:
                continue
            ap = albedo0.at[m, c].add(eps)
            am = albedo0.at[m, c].add(-eps)
            fd = (float(f(ap)) - float(f(am))) / (2 * eps)
            rel = abs(fd - g[m, c]) / max(abs(fd), abs(g[m, c]), 1e-8)
            # Sampling is detached & seeds fixed → paths identical across
            # FD evals except lobe-pick flips; tolerate small residual.
            assert rel < 0.05, (m, c, fd, g[m, c])
            checked += 1
    assert checked >= 3


def test_emission_gradient_matches_fd():
    scene = build_cornell_simple()
    cam = demo_camera(RES, RES)
    em0 = scene.mat_emission

    def f(em):
        return _mean_radiance(replace_emission(scene, em), cam)

    g = np.asarray(jax.grad(f)(em0))
    assert np.isfinite(g).all()
    m = int(np.argmax(np.abs(g).sum(axis=1)))
    eps = 1e-2
    fd = (float(f(em0.at[m, 0].add(eps))) -
          float(f(em0.at[m, 0].add(-eps)))) / (2 * eps)
    # Radiance is LINEAR in emission given fixed paths → FD is exact.
    rel = abs(fd - g[m, 0]) / max(abs(fd), 1e-8)
    assert rel < 1e-2, (fd, g[m, 0])


def test_vertex_and_camera_gradients_finite():
    # Vertex gradients need a smooth dependence of radiance on position:
    # the flat-shaded box has none (normals constant per face, visibility
    # discrete), but the demo spheres' interpolated normals vary with the
    # barycentrics, which vary with the vertices.
    from gdpathtracing.scene.demo import build_demo_scene
    scene = build_demo_scene(texture_resolution=4, sphere_detail=4, geometry="sphere")
    cam = demo_camera(16, 16)

    g_v = jax.grad(
        lambda tp: _mean_radiance(replace_vertices(scene, tp), cam)
    )(scene.tri_pos)
    g_v = np.asarray(g_v)
    assert np.isfinite(g_v).all()
    assert np.abs(g_v).max() > 0.0  # geometry influences radiance
    scene = build_cornell_simple()

    g_c = jax.grad(
        lambda tf: _mean_radiance(scene, replace_camera_transform(cam, tf))
    )(cam.transform)
    g_c = np.asarray(g_c)
    assert np.isfinite(g_c).all()
    assert np.abs(g_c).max() > 0.0


def test_render_loss_and_optimization_step_decreases():
    """One SGD step on albedo against a darker target must reduce the loss
    (inverse-rendering smoke, BASELINE config 4)."""
    scene = build_cornell_simple()
    cam = demo_camera(16, 16)
    target = np.asarray(render_radiance(scene, cam, CFG, 0).radiance) * 0.5
    target = jnp.asarray(target)

    def loss(albedo):
        return render_loss(albedo, replace_albedo, scene, cam, CFG, target)

    l0, g = jax.value_and_grad(loss)(scene.mat_albedo)
    albedo1 = scene.mat_albedo - 0.5 * g
    l1 = loss(albedo1)
    assert float(l1) < float(l0)


def test_unbiased_mse_grad_converges_from_perturbation():
    """Decorrelated-gradient inverse rendering: starting near the truth,
    Adam must reduce albedo error on well-observed materials (a correlated
    single-sample MSE gradient provably diverges here — the estimator-
    variance term; see diff/inverse.py)."""
    import optax
    from gdpathtracing.diff.inverse import unbiased_mse_value_and_grad

    cfg = RenderConfig(bounces=2, spp=4, traversal=Traversal.UNIT,
                       jitter=Jitter.NONE)
    scene = build_cornell_simple()
    cam = demo_camera(32, 32)
    target = render_radiance(scene, cam, cfg.replace(spp=32), 0).radiance
    truth = scene.mat_albedo
    key = jax.random.PRNGKey(1)
    init = jnp.clip(truth + jax.random.uniform(key, truth.shape,
                                               minval=-0.1, maxval=0.1),
                    0.05, 1.0)
    opt = optax.adam(0.01)

    @jax.jit
    def step(albedo, s, i):
        loss, g = unbiased_mse_value_and_grad(
            albedo, replace_albedo, scene, cam, cfg, target,
            500 + 2 * i, 501 + 2 * i)
        up, s = opt.update(g, s)
        return jnp.clip(jax.tree_util.tree_map(lambda a, b: a + b, albedo, up),
                        0.0, 1.0), s, loss

    a, s = init, opt.init(init)
    for i in range(60):
        a, s, _ = step(a, s, i)
    err0 = np.abs(np.asarray(init - truth))
    err1 = np.abs(np.asarray(a - truth))
    # Green wall (index 4) is large in frame → must improve; and nothing
    # may blow up the way the correlated estimator does (≥0.5 drift).
    assert err1[4].max() < err0[4].max()
    assert err1.max() < 0.3, err1.max(axis=1)


def test_pallas_vertex_gradient_matches_fd():
    """Vertex gradients through the FAST path.
    replace_vertices rebuilds the isect tables in-graph
    (scene/dynamic.update_vertices), so trace_pallas_diff's recompute
    epilogue — t, u, v from isect_cols — is a differentiable function of
    tri_pos; the normal-interpolation term (sphere scene) gives a smooth
    interior dependence to FD against. Per-sample FD-match requires the
    ATTACHED gradient strategy (config.grad_attached: nothing detached →
    jax.grad is the exact chain-rule derivative of the primal estimator;
    the detached default is a different — also unbiased — estimator that
    only agrees in expectation). Silhouette pixels are excluded from the
    loss (hard visibility flips are the known-unmodeled term)."""
    from gdpathtracing.scene.demo import build_demo_scene

    scene = build_demo_scene(texture_resolution=4, sphere_detail=6,
                             geometry="sphere")
    cam = demo_camera(RES, RES)
    cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                       jitter=Jitter.NONE, differentiable=True,
                       grad_attached=True)

    # Interior mask: pixels whose 8-neighborhood all hit the same instance
    # stay off the silhouettes (winner flips under FD are continuous across
    # shared mesh edges but not across object boundaries).
    base = render_radiance(scene, cam, cfg, 0)
    depth = np.asarray(base.depth)
    hitm = depth < 999.0
    interior = hitm.copy()
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            interior &= np.roll(np.roll(hitm, sy, 0), sx, 1)
    w = jnp.asarray(interior.astype(np.float32))[:, :, None]

    def f(tp):
        s = replace_vertices(scene, tp)
        rad = render_radiance(s, cam, cfg, 0).radiance
        return jnp.sum(rad * w) / jnp.sum(w)

    tp0 = scene.tri_pos
    g = np.asarray(jax.grad(f)(tp0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0

    flat = np.abs(g).reshape(-1)
    cand = np.argsort(-flat)[:24]
    # eps balances central-difference truncation against f32 roundoff of
    # the scalar loss (~1e-7 relative / 2eps absolute FD noise): 5e-3
    # puts the noise floor ~1e-5, well under the ~1e-3 top components.
    eps = 5e-3
    checked = 0
    rels = []
    for ci in cand:
        ti, vi, xi = np.unravel_index(ci, g.shape)
        if abs(g[ti, vi, xi]) < 1e-4:
            continue
        fd = (float(f(tp0.at[ti, vi, xi].add(eps)))
              - float(f(tp0.at[ti, vi, xi].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[ti, vi, xi]) / max(abs(fd), abs(g[ti, vi, xi]),
                                            1e-8)
        rels.append((rel, ti, vi, xi, fd, float(g[ti, vi, xi])))
        checked += 1
        if checked >= 6:
            break
    assert checked >= 4, rels
    # Most components FD-match tightly; tolerate ONE outlier (a component
    # whose perturbation crosses a secondary-visibility threshold).
    good = sorted(r[0] for r in rels)
    assert good[len(good) // 2] < 0.05, rels   # median tight
    assert sum(r < 0.10 for r in good) >= checked - 1, rels


def test_pallas_diff_gradient_matches_fd():
    """The PALLAS path must be differentiable. With
    config.differentiable the kernel becomes a primal hit-finder and the
    hit record is recomputed differentiably (trace_pallas_diff); the
    per-bounce loop is jax.checkpoint'ed. FD-match albedo gradients against
    the kernel-traced render, and check the primal value is unchanged."""
    from gdpathtracing.scene.demo import build_demo_scene

    scene = build_demo_scene(texture_resolution=4, sphere_detail=6,
                             geometry="sphere")
    cam = demo_camera(RES, RES)
    for nee in (False, True):
        cfg = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                           jitter=Jitter.NONE, nee=nee,
                           differentiable=True)

        def f(albedo):
            s = replace_albedo(scene, albedo)
            return jnp.mean(render_radiance(s, cam, cfg, 0).radiance)

        # Primal parity: diff mode must not change the image.
        prim = render_radiance(scene, cam, cfg, 0).radiance
        base = render_radiance(scene, cam,
                               cfg.replace(differentiable=False),
                               0).radiance
        assert np.allclose(np.asarray(prim), np.asarray(base),
                           rtol=1e-5, atol=1e-6), f"nee={nee}"

        albedo0 = scene.mat_albedo
        g = np.asarray(jax.grad(f)(albedo0))
        assert np.isfinite(g).all()
        eps = 1e-3
        checked = 0
        mats = np.argsort(-np.abs(g).sum(axis=1))[:2]
        for m in mats:
            for c in range(3):
                if abs(g[m, c]) < 1e-5:
                    continue
                fd = (float(f(albedo0.at[m, c].add(eps)))
                      - float(f(albedo0.at[m, c].add(-eps)))) / (2 * eps)
                rel = abs(fd - g[m, c]) / max(abs(fd), abs(g[m, c]), 1e-8)
                assert rel < 0.05, (nee, m, c, fd, g[m, c])
                checked += 1
        assert checked >= 2, f"nee={nee}"


def test_bwd_checkpoint_paths_agree_and_auto_resolves():
    """config.bwd_checkpoint True / False / None (shape-aware auto) must
    produce identical losses and gradients — the auto rule only trades
    backward memory for recompute. Also pins the
    auto threshold arithmetic: small frames resolve to False, frames
    whose estimated residuals exceed the budget resolve to True."""
    scene = build_cornell_simple()
    cam = demo_camera(RES, RES)
    base = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                        jitter=Jitter.NONE, differentiable=True)

    def grad_of(cfg):
        def f(albedo):
            return jnp.mean(render_radiance(replace_albedo(scene, albedo),
                                            cam, cfg, 0).radiance)
        return np.asarray(jax.grad(f)(scene.mat_albedo))

    g_save = grad_of(base.replace(bwd_checkpoint=False))
    g_ckpt = grad_of(base.replace(bwd_checkpoint=True))
    g_auto = grad_of(base)  # None -> auto (tiny frame -> False)
    assert np.isfinite(g_save).all() and np.abs(g_save).max() > 0
    np.testing.assert_allclose(g_ckpt, g_save, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(g_auto, g_save, rtol=1e-6, atol=1e-8)

    # Auto threshold arithmetic: force a 1-byte budget -> checkpoint on
    # (still identical values, now through the jax.checkpoint path).
    g_forced = grad_of(base.replace(bwd_resid_budget=1))
    np.testing.assert_allclose(g_forced, g_save, rtol=1e-6, atol=1e-8)
