"""The path-tracing integrator: iterative bounce loop over a ray wavefront.

Re-expression of path_trace (main.glsl:372-401) as a ``lax.fori_loop`` whose
carry is the whole SoA wavefront state. Same light transport as the
reference: BRDF importance sampling only (no NEE / MIS vs lights / Russian
roulette), ``radiance += throughput * emission`` per segment, sky on miss,
hard bounce cap, ray-origin epsilon offset along the shading normal.

Differentiability: the sampled direction and the pdf are wrapped in
``stop_gradient`` (detached sampling) so that ``jax.grad`` of the radiance
w.r.t. scene parameters (albedo, emission, roughness, vertices, camera)
yields the unbiased interior-derivative estimator; visibility
discontinuities are handled separately (diff/).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.core import rng
from gdpathtracing.core.vec import Vec3, reflect, where as vwhere
from gdpathtracing.render import brdf
from gdpathtracing.render.intersect import trace_brute
from gdpathtracing.render.shading import get_shading_data
from gdpathtracing.render.sky import sample_sky
from gdpathtracing.render.types import HitInfo, Ray
from gdpathtracing.scene.scene import Scene

TraceFn = Callable[[Scene, Ray, jnp.ndarray], HitInfo]


def get_trace_fn(config: RenderConfig, scene: Scene | None = None
                 ) -> TraceFn:
    """Build the traversal closure. Passing `scene` lets the pallas
    backend assemble its per-triangle table ONCE (outside the bounce/tile
    loops) instead of per trace call."""
    if config.traversal == Traversal.BRUTE:
        return lambda scene, ray, active: trace_brute(scene, ray, active)
    if config.traversal == Traversal.BVH:
        from gdpathtracing.render.traverse import trace_bvh
        return lambda scene, ray, active: trace_bvh(
            scene, ray, active, max_stack=config.max_stack)
    if config.traversal == Traversal.UNIT:
        from gdpathtracing.render.intersect import trace_unit
        return lambda scene, ray, active: trace_unit(scene, ray, active)
    if config.traversal == Traversal.PALLAS:
        from gdpathtracing.ops.intersect_pallas import (
            prepare_trace_inputs, trace_pallas, trace_pallas_diff)
        prep = prepare_trace_inputs(scene) if scene is not None else None
        baked = scene
        trace = trace_pallas_diff if config.differentiable else trace_pallas

        def pallas_fn(scene, ray, active):
            # `prep` bakes geometry/material tables from the closure-time
            # scene; a caller passing a DIFFERENT scene (e.g. after
            # update_instance_transforms) must not trace stale tables —
            # rebuild prep for it (identity check is Python-level, free
            # under jit).
            p = prep if scene is baked else None
            return trace(scene, ray, active, prep=p)

        return pallas_fn
    raise ValueError(config.traversal)


class PathTraceResult(NamedTuple):
    radiance: Vec3          # (N,) per ray
    depth: jnp.ndarray      # (N,) linear distance of first hit (far if miss)
    steps: jnp.ndarray      # (N,) triangle tests — DEBUG_STEPS analog
    segments: jnp.ndarray   # (N,) ray segments actually traced (≤ bounces)
    normal: Vec3            # (N,) first-hit shading normal (0 on miss)


def path_trace(scene: Scene, ray: Ray, seed, config: RenderConfig,
               trace_fn: TraceFn | None = None,
               far: float = 1000.0) -> PathTraceResult:
    """Trace one path per ray; all rays advance in lockstep through the
    bounce loop with an `active` mask (main.glsl:372-401).

    With ``config.nee`` enabled, each bounce adds a direct-light sample
    (shadow ray toward an emitter) and BRDF/light contributions are
    combined with the power heuristic — identical expectation to the
    reference's transport, far lower variance.
    """
    if trace_fn is None:
        trace_fn = get_trace_fn(config, scene)
    n = ray.o.x.shape[0]
    f32 = jnp.float32

    fast_shading = config.traversal in (Traversal.UNIT, Traversal.PALLAS)
    use_nee = config.nee and scene.n_lights > 0
    if use_nee:
        from gdpathtracing.render import lights as lights_mod
        light_table = lights_mod.build_light_table(scene)

    if use_nee and config.traversal == Traversal.PALLAS:
        from gdpathtracing.ops.intersect_pallas import (
            occluded_pallas, prepare_trace_inputs)
        occ_prep = prepare_trace_inputs(scene)

    # Large scenes (superchunk traversal): stable-sort the wavefront by
    # direction octant each bounce. The chunk/superchunk culling is per
    # ray BLOCK — after a diffuse bounce a block of random directions
    # collectively may-hits everything, so culling dies. Octant-sorting
    # restores directional block coherence while the stable order keeps
    # pixel-adjacent (origin-coherent) rays together; dead rays (key 8)
    # compact to the tail where whole blocks park and skip. Per-ray math
    # is order-independent, so results are identical after unsorting up to
    # fp-conservatism of the per-block slab cull (a grazing ray whose own
    # slab test misses by an ulp can still be swept when a neighbor forces
    # the chunk — block composition decides; the equality test covers the
    # practical case, not an absolute guarantee).
    sort_rays = config.sort_rays
    if sort_rays is None:
        # Auto: on for PALLAS scenes of more than 128 chunks, where an
        # incoherent block would otherwise sweep most of them.
        sort_rays = (config.traversal == Traversal.PALLAS
                     and scene.isect_mu.shape[1] > 128 * 256)
    # Survivor compaction without the Morton sort, at GROUP granularity
    # (see the body below): stable partition of 128-ray groups by
    # any-live — survivors keep their pixel-coherent order, dead groups
    # pack into tail blocks that slab-cull every chunk, and each permute
    # is a contiguous row gather. Sort subsumes compaction (dead rays are
    # already keyed last), so sort wins when both are on.
    compact_rays = config.compact_rays
    if compact_rays is None:
        # Auto-on for flat-scene PALLAS wavefronts big enough that parked
        # tail blocks pay for the (cheap, group-row-gather) permutes:
        # bounce 2+ of the demo frame is ~14% live, image-clustered.
        compact_rays = (config.traversal == Traversal.PALLAS
                        and not sort_rays and n >= 65536)
    compact_rays = (bool(compact_rays)
                    and not sort_rays
                    and config.traversal == Traversal.PALLAS)
    _cg = next((gsz for gsz in (128, 32, 8) if n % gsz == 0), None)
    if _cg is None:
        compact_rays = False
    reorder = sort_rays or compact_rays

    def body(i, carry):
        if reorder:
            (ray_o, ray_d, throughput, radiance, active, seed, depth,
             steps, segments, prev_pdf, normal, src) = carry
            if sort_rays:
                # Key = Morton cell of the ray ORIGIN (major, 8³ scene
                # cells) then direction octant (minor): blocks get tight
                # origin bounds AND a shared direction cone — both are
                # what the per-block slab culling needs. Octant-only
                # sorting measured only 1.4x on the grid scene: once
                # survivors are sparse, an octant's rays come from all
                # over the image and the block's origin AABB covers the
                # whole scene.
                def q3(x, lo, span):
                    return jnp.clip(
                        ((x - lo) / span * 8.0).astype(jnp.int32), 0, 7)

                cb = scene.isect_chunk_bounds
                lo = cb[0:3].min(axis=1)
                span = jnp.maximum(cb[3:6].max(axis=1) - lo, 1e-6)
                qx = q3(ray_o.x, lo[0], span[0])
                qy = q3(ray_o.y, lo[1], span[1])
                qz = q3(ray_o.z, lo[2], span[2])
                cell = jnp.zeros_like(qx)
                for b in range(3):  # 9-bit Morton interleave of 3-bit
                    cell = cell | (((qx >> b) & 1) << (3 * b + 2)) \
                        | (((qy >> b) & 1) << (3 * b + 1)) \
                        | (((qz >> b) & 1) << (3 * b))
                octant = ((ray_d.x > 0.0).astype(jnp.int32) * 4
                          + (ray_d.y > 0.0).astype(jnp.int32) * 2
                          + (ray_d.z > 0.0).astype(jnp.int32))
                key = cell * 8 + octant
                key = jnp.where(active, key, 1 << 14)  # dead rays last
                order = jnp.argsort(key, stable=True)
                def g(x):
                    return x[order]
            else:
                # GROUP-granular compaction: partition the wavefront in
                # GROUPS of _cg=128 consecutive rays: group live = any(live
                # in group); live groups pack first (stable), dead groups
                # park in tail blocks that slab-cull every chunk.
                # Survivors are image-clustered (sky/light pixels die in
                # contiguous raster runs), so group granularity recovers
                # most of the per-ray packing while each permute is a
                # contiguous 512-byte row gather.
                glive = jnp.any(active.reshape(-1, _cg), axis=1)
                ng = glive.shape[0]
                r_live = jnp.cumsum(glive.astype(jnp.int32))
                r_dead = jnp.cumsum((~glive).astype(jnp.int32))
                gdest = jnp.where(glive, r_live - 1,
                                  r_live[-1] + r_dead - 1)
                gorder = jnp.zeros(ng, jnp.int32).at[gdest].set(
                    jnp.arange(ng, dtype=jnp.int32))

                def g(x):
                    return x.reshape(-1, _cg)[gorder].reshape(-1)

            def gv(v):
                return Vec3(g(v.x), g(v.y), g(v.z))

            ray_o, ray_d = gv(ray_o), gv(ray_d)
            throughput, radiance = gv(throughput), gv(radiance)
            normal = gv(normal)
            active, depth, steps = g(active), g(depth), g(steps)
            segments, prev_pdf, src = g(segments), g(prev_pdf), g(src)
            seed = (g(seed[0]), g(seed[1]))
            carry_tail = (src,)
        else:
            (ray_o, ray_d, throughput, radiance, active, seed, depth,
             steps, segments, prev_pdf, normal) = carry
            carry_tail = ()
        r = Ray(ray_o, ray_d)
        hit = trace_fn(scene, r, active)
        is_hit = hit.hit & active
        steps = steps + jnp.where(active, hit.steps, 0)
        segments = segments + active.astype(jnp.int32)

        s = get_shading_data(scene, hit, r, fast=fast_shading)
        sky = sample_sky(ray_d, config, scene)
        if config.soft_primary > 0.0:
            # Differentiable primary-silhouette relaxation (SoftRas-style,
            # BASELINE config 4's visibility-discontinuity term for the
            # first hit): the winner's barycentric edge margin drives a
            # coverage alpha that is 0 exactly ON the silhouette —
            # continuous with the miss side — and saturates to 1 a few
            # edge-widths inside. All surface terms of this bounce
            # (emission pickup, NEE direct, path continuation) scale by
            # alpha; the uncovered (1 - alpha) share takes the environment
            # instead. Gradients of alpha flow through u/v to vertices,
            # instance poses and the camera (the trace backends recompute
            # u/v differentiably). Python-level gate: eps = 0 leaves the
            # graph — and every golden — untouched.
            # Margin over OPEN (mesh-boundary) edges only: interior seams
            # (quad diagonals) are not silhouettes; a hit is always inside
            # all three edges, so no interior gate is needed here.
            eo = scene.tri_edge_open[hit.tri]  # (N, 3)
            margin = jnp.minimum(
                jnp.minimum(jnp.where(eo[:, 0] > 0, hit.u, 1.0),
                            jnp.where(eo[:, 1] > 0, hit.v, 1.0)),
                jnp.where(eo[:, 2] > 0, 1.0 - hit.u - hit.v, 1.0))
            alpha = 2.0 * jax.nn.sigmoid(
                jnp.maximum(margin, 0.0) / config.soft_primary) - 1.0
            first_hit = (i == 0) & is_hit
            radiance = vwhere(first_hit,
                              radiance + throughput * sky * (1.0 - alpha),
                              radiance)
            a1 = jnp.where(first_hit, alpha, 1.0)
            throughput = throughput * a1
        emission = vwhere(is_hit, s.emission, sky)
        if use_nee:
            # MIS weight for BRDF-sampled emitter pickup (camera rays and
            # sky keep weight 1; prev_pdf < 0 marks "not a BRDF sample").
            if fast_shading:
                pl = lights_mod.light_pdf_of_eidx(light_table, scene,
                                                  hit.eidx, r.d, hit.t)
            else:
                pl = lights_mod.light_pdf_of_hit(light_table, scene,
                                                 hit.inst, hit.tri,
                                                 r.d, hit.t)
            pb = jnp.maximum(prev_pdf, 0.0)
            w_mis = jnp.where(
                (prev_pdf > 0.0) & is_hit & (pl > 0.0),
                (pb * pb) / jnp.maximum(pb * pb + pl * pl, 1e-20), 1.0)
            emission = emission * w_mis
        add = throughput * emission
        radiance = vwhere(active, radiance + add, radiance)

        if use_nee:
            # Direct-light (shadow) sample from this hit.
            (lr1, lr2), seed = rng.pcg2d(seed)
            (lr3, _), seed = rng.pcg2d(seed)
            ls = lights_mod.sample_light(light_table, s.position,
                                         lr3, lr1, lr2)
            cos_i = s.normal.dot(ls.wi)
            shadow_o = s.position + s.normal * config.ray_eps
            shadow_active = is_hit & (cos_i > 0.0) & \
                jnp.isfinite(ls.pdf_solid)
            if config.soft_shadows > 0.0 and config.traversal in (
                    Traversal.BRUTE, Traversal.UNIT, Traversal.PALLAS):
                # Differentiable soft visibility (silhouette gradients
                # w.r.t. blocker geometry) — intersect.occlusion_soft.
                from gdpathtracing.render.intersect import occlusion_soft
                visibility = occlusion_soft(
                    scene, Ray(shadow_o, ls.wi), ls.dist * (1.0 - 1e-3),
                    shadow_active, edge_eps=config.soft_shadows)
            elif config.traversal == Traversal.PALLAS:
                # Dedicated any-hit kernel: no closest-hit bookkeeping,
                # a block stops once all its rays are resolved. Hard
                # visibility is detached (zero a.e. derivative): the
                # kernel sees stop-gradient inputs.
                occluded = occluded_pallas(
                    scene, Ray(shadow_o, ls.wi), ls.dist * (1.0 - 1e-3),
                    shadow_active, prep=occ_prep)
                visibility = (~occluded).astype(jnp.float32)
            else:
                sh = trace_fn(scene, Ray(shadow_o, ls.wi), shadow_active)
                visibility = (~(sh.t < ls.dist * (1.0 - 1e-3))
                              ).astype(jnp.float32)
            segments = segments + shadow_active.astype(jnp.int32)
            f_l = brdf.eval_brdf(s, ls.wi)
            sgp = (lambda x: x) if config.grad_attached \
                else jax.lax.stop_gradient
            pb_l = sgp(brdf.brdf_pdf(s, ls.wi))
            pl_l = sgp(ls.pdf_solid)
            # Sanitize the inf sentinel (grazing light sample) BEFORE any
            # arithmetic: inf/inf = NaN in the primal w_l, and although the
            # where() masks it, the backward pass multiplies that NaN into
            # the cos_i branch (NaN · 0-cotangent = NaN) — poisoning vertex
            # and camera gradients while leaving albedo gradients clean.
            pl_ok = jnp.isfinite(pl_l) & (pl_l > 1e-12)
            pl_safe = jnp.where(pl_ok, pl_l, 1.0)
            w_l = (pl_safe * pl_safe) / jnp.maximum(
                pl_safe * pl_safe + pb_l * pb_l, 1e-20)
            scale_l = jnp.where(shadow_active & pl_ok,
                                cos_i * w_l / pl_safe, 0.0)
            scale_l = scale_l * visibility
            direct = throughput * f_l * ls.emission * scale_l
            if scene.has_transmission:
                direct = direct * (1.0 - s.transmission)
            radiance = vwhere(active, radiance + direct, radiance)

        # First-hit distance → depth AOV (main.glsl:382-383) + normal AOV
        # (denoiser guide).
        dist = (s.position - ray_o).length()
        depth = jnp.where((i == 0) & is_hit, dist, depth)
        first = (i == 0) & is_hit
        normal = vwhere(first, s.normal, normal)

        # Next segment: BRDF sampling — detached (direction + pdf
        # stop-gradient'ed) by default, fully attached when
        # config.grad_attached (per-sample FD-matchable; see config.py).
        (r1, r2), seed = rng.pcg2d(seed)
        new_dir = brdf.sample_brdf(s, r1, r2)
        if not config.grad_attached:
            new_dir = Vec3(jax.lax.stop_gradient(new_dir.x),
                           jax.lax.stop_gradient(new_dir.y),
                           jax.lax.stop_gradient(new_dir.z))
        pdf = brdf.brdf_pdf(s, new_dir)
        if not config.grad_attached:
            pdf = jax.lax.stop_gradient(pdf)
        lambert_in = s.normal.dot(new_dir)
        f = brdf.eval_brdf(s, new_dir)
        scale = jnp.where(pdf > 1e-12, lambert_in / jnp.maximum(pdf, 1e-12),
                          0.0)
        mult = f * scale
        survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
        offset = s.normal * config.ray_eps  # main.glsl:385
        prev_pdf_val = pdf

        if scene.has_transmission:
            # Dielectric delta lobe (wishlist "Transparent materials"):
            # picked with probability `transmission`; Fresnel chooses
            # reflect vs refract; throughput *= albedo tint.
            (r3, r4), seed = rng.pcg2d(seed)
            pick_t = r3 < s.transmission
            eta = jnp.where(hit.front, 1.0 / s.ior, s.ior)
            fres = brdf.fresnel_dielectric(s.lambert_out, eta)
            refr_dir, tir = brdf.refract(r.d, s.normal, eta)
            refl_dir = reflect(r.d, s.normal)
            do_reflect = (r4 < fres) | tir
            delta_dir = vwhere(do_reflect, refl_dir, refr_dir)
            new_dir = vwhere(pick_t, delta_dir, new_dir)
            mult = vwhere(pick_t, s.albedo, mult)
            survive = jnp.where(pick_t, is_hit, survive)
            offset = vwhere(pick_t & ~do_reflect, -offset, offset)
            prev_pdf_val = jnp.where(pick_t, -1.0, prev_pdf_val)
            lambert_in = jnp.where(pick_t, 1.0, lambert_in)

        new_throughput = throughput * mult

        if config.rr_start > 0:
            # Russian roulette: from bounce rr_start
            # on, continue with probability p = max component of the NEXT
            # segment's throughput (clamped) and compensate by 1/p —
            # E[throughput] unchanged, expected path length shortened.
            # p is detached (a sampling decision, like the BRDF pdf);
            # gated at the Python level so rr_start=0 leaves the RNG
            # stream — and every golden — untouched.
            (r5, _), seed = rng.pcg2d(seed)
            lum = jnp.maximum(new_throughput.x,
                              jnp.maximum(new_throughput.y,
                                          new_throughput.z))
            p = jax.lax.stop_gradient(
                jnp.clip(lum, config.rr_min_p, 1.0))
            do_rr = i >= config.rr_start
            survive = survive & jnp.where(do_rr, r5 < p, True)
            boost = jnp.where(do_rr, 1.0 / p, 1.0)
            new_throughput = new_throughput * boost

        new_o = s.position + offset
        ray_o = vwhere(survive, new_o, ray_o)
        ray_d = vwhere(survive, new_dir, ray_d)
        throughput = vwhere(survive, new_throughput, throughput)
        active = survive
        prev_pdf = jnp.where(survive, prev_pdf_val, -1.0)
        return (ray_o, ray_d, throughput, radiance, active, seed, depth,
                steps, segments, prev_pdf, normal) + carry_tail

    # Carries derive from `ray` arithmetically so they inherit its
    # varying-axes type under shard_map (cf. HitInfo.none_like).
    zero_n = ray.o.x * 0.0
    one3 = Vec3(zero_n + 1.0, zero_n + 1.0, zero_n + 1.0)
    zero3 = Vec3(zero_n, zero_n, zero_n)
    init = (ray.o, ray.d, one3, zero3,
            zero_n.astype(bool) | True, seed,
            zero_n + f32(far), zero_n.astype(jnp.int32),
            zero_n.astype(jnp.int32), zero_n - 1.0, zero3)
    if reorder:
        init = init + (zero_n.astype(jnp.int32) + jnp.arange(n),)
    if config.differentiable:
        # Reverse-mode memory: checkpoint each bounce so the backward pass
        # recomputes the bounce's interior instead of saving every
        # intermediate — residuals stay O(wavefront), not
        # O(wavefront × bounces × ops) (SURVEY.md §7.6 hard part #2).
        # config.bwd_checkpoint=False trades that memory back for speed
        # (no recompute) where the residuals fit device memory; None =
        # shape-aware auto (estimate residual bytes, checkpoint only past
        # the budget — the 4K/deep-path out-of-memory guard).
        ckpt = config.bwd_checkpoint
        if ckpt is None:
            resid = n * config.bounces * config.bwd_resid_bytes_per_seg
            ckpt = resid > config.bwd_resid_budget
        ckpt_body = (lambda carry, i: (body(i, carry), None))
        if ckpt:
            ckpt_body = jax.checkpoint(ckpt_body)
        out, _ = jax.lax.scan(ckpt_body, init,
                              jnp.arange(config.bounces))
    else:
        out = jax.lax.fori_loop(0, config.bounces, body, init)
    radiance, depth, steps, segments, normal = (out[3], out[6], out[7],
                                                out[8], out[10])
    if reorder:
        # Scatter every per-ray output back to its source slot (the
        # composed per-bounce permutation lives in `src`).
        src = out[11]

        def unsort(x):
            return jnp.zeros_like(x).at[src].set(x)

        radiance = Vec3(unsort(radiance.x), unsort(radiance.y),
                        unsort(radiance.z))
        normal = Vec3(unsort(normal.x), unsort(normal.y), unsort(normal.z))
        depth, steps, segments = (unsort(depth), unsort(steps),
                                  unsort(segments))
    return PathTraceResult(radiance=radiance, depth=depth, steps=steps,
                           segments=segments, normal=normal)
