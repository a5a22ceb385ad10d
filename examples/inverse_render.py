"""Inverse rendering demo (BASELINE config 4): recover material albedos
from a target image by gradient descent through the renderer.

Renders the Cornell demo with its true albedos as the target, perturbs the
albedos, then optimizes them back with Adam. No reference counterpart —
this is a capability the differentiable design adds.

Usage: python examples/inverse_render.py [--steps 60] [--res 64]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--spp-target", type=int, default=32)
    ap.add_argument("--spp-opt", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from gdpathtracing.config import Jitter, RenderConfig, Traversal
    from gdpathtracing.diff.inverse import (render_loss, replace_albedo,
                                                unbiased_mse_value_and_grad)
    from gdpathtracing.render.renderer import render_radiance
    from gdpathtracing.scene.demo import build_cornell_simple, demo_camera

    cfg = RenderConfig(bounces=args.bounces, spp=args.spp_opt,
                       traversal=Traversal.UNIT, jitter=Jitter.NONE)
    scene = build_cornell_simple()
    cam = demo_camera(args.res, args.res)

    # Converged target: average many independently-seeded frames. The
    # optimization then uses FRESH seeds each step — per-sample lobe-pick
    # discontinuities average out (randomized smoothing) and Adam sees
    # unbiased gradients of the expected image.
    tgt_cfg = cfg.replace(spp=args.spp_target)
    target = render_radiance(scene, cam, tgt_cfg, 0).radiance
    true_albedo = scene.mat_albedo

    # Perturb: grey everything (keep slot 0 default + light emission).
    rng = jax.random.PRNGKey(0)
    init = jnp.clip(true_albedo +
                    jax.random.uniform(rng, true_albedo.shape,
                                       minval=-0.4, maxval=0.4), 0.05, 1.0)

    opt = optax.adam(args.lr)

    # Only materials the image actually constrains: the emissive light's
    # albedo and the unused default have ~zero gradient and would drift.
    g0 = jax.grad(render_loss)(init, replace_albedo, scene, cam, cfg,
                               target, 0)
    observed = (jnp.abs(g0).sum(axis=1) > 1e-6)[:, None]

    def err(albedo):
        return float(jnp.abs(jnp.where(observed, albedo - true_albedo,
                                       0.0)).max())

    @jax.jit
    def step(albedo, opt_state, i):
        # Decorrelated (unbiased) MC gradient of the MSE — see
        # diff/inverse.py:unbiased_mse_value_and_grad.
        loss, grad = unbiased_mse_value_and_grad(
            albedo, replace_albedo, scene, cam, cfg, target,
            1000 + 2 * i, 1001 + 2 * i)
        updates, opt_state = opt.update(grad, opt_state)
        albedo = jnp.clip(optax.apply_updates(albedo, updates), 0.0, 1.0)
        return albedo, opt_state, loss

    albedo = init
    opt_state = opt.init(albedo)
    t0 = time.time()
    for i in range(args.steps):
        albedo, opt_state, loss = step(albedo, opt_state, i)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss={float(loss):.6f}  "
                  f"max|albedo err|={err(albedo):.4f}", flush=True)
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")
    final_err = err(albedo)
    print(f"final max albedo error (observed materials): {final_err:.4f} "
          f"({'OK' if final_err < 0.15 else 'POOR'})")


if __name__ == "__main__":
    main()
