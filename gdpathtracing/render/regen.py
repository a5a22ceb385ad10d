"""Path-regeneration integrator: a persistent, always-full wavefront.

In the standard per-bounce loop (render/integrator.py) ray death is
spatially scattered, so nearly every ray block keeps at least one live ray
and pays the full sweep while its dead lanes idle. Regeneration removes
the waste at its source: every dead lane is immediately REFILLED with the
next unstarted path (camera ray) of the frame's pool, so the wavefront
stays ~100% live and the sweep cost tracks the real segment count — the
persistent-threads path regeneration of GPU wavefront schedulers (the
reference's SIMT kernel gets the same effect from early thread exit plus a
new dispatch per frame, main.glsl:372-436).

A fresh camera ray is pure arithmetic of its path id (pixel = id % n_pix,
sample = id // n_pix, RNG seed = hash(px, py, frame·spp + sample)), so
dead lanes compute their replacement in place, without gathers.

Retirement: each iteration the lane permutation (live < freshly dead <
stale) makes the retirements one contiguous block, appended with ONE
dynamic_update_slice into a (LOG_R, n_paths + nw) column-major log; one
transpose and one 8-wide row gather at frame end land everything
pid-indexed (``regen_retire="log"``, the default). ``"scatter"`` writes
each retired column with a masked scatter instead (kept as the reference
the log is tested against). The frame tail is straggler-bound, so once
the pool is exhausted the sorted live prefix moves to smaller
while_loops (the two-stage drain).

Transport: per-path RNG streams and per-segment math are exactly the
standard integrator's, so each path's radiance matches path_trace
bit-for-bit (the traversal winner does not depend on block composition).
Oracle test: tests/test_regen.py compares against path_trace.

Limits: primal only (lax.while_loop is not reverse-differentiable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gdpathtracing.config import RenderConfig, Traversal
from gdpathtracing.core import rng
from gdpathtracing.core.vec import Vec3, reflect, where as vwhere
from gdpathtracing.render import brdf
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.integrator import get_trace_fn
from gdpathtracing.render.shading import get_shading_data
from gdpathtracing.render.sky import sample_sky
from gdpathtracing.render.types import Ray
from gdpathtracing.scene.scene import Scene

OUT_COLS = 9  # r g b | depth | nx ny nz | steps | segments — one 1-D
#               (n_paths,) output buffer per column (pid-indexed)

def regen_supported(scene: Scene, config: RenderConfig) -> bool:
    """Gate for the regeneration frame loop (renderer auto path)."""
    return (config.traversal in (Traversal.PALLAS, Traversal.UNIT,
                                 Traversal.BRUTE)
            and not config.differentiable
            and config.soft_shadows == 0.0
            and config.soft_primary == 0.0)


def regen_auto(scene: Scene, config: RenderConfig) -> bool:
    """config.regen=None policy: every supported PALLAS render takes the
    regeneration loop."""
    return (config.traversal == Traversal.PALLAS
            and regen_supported(scene, config))


def render_radiance_regen(scene: Scene, camera: Camera,
                          config: RenderConfig, frame_index=0,
                          return_stats: bool = False):
    """Full-frame trace with path regeneration. Returns FrameAOVs
    (same contract as renderer.render_radiance); with ``return_stats``,
    (FrameAOVs, stats) with per-iteration live-lane and chunk-sweep
    counts for perf diagnostics."""
    from gdpathtracing.render.renderer import FrameAOVs

    w, h = camera.width, camera.height
    n_pix = w * h
    n_paths = n_pix * config.spp
    nw = min(config.regen_wavefront, -(-n_paths // 256) * 256)
    frame_index = jnp.asarray(frame_index, dtype=jnp.uint32)
    f32 = jnp.float32

    trace_fn = get_trace_fn(config, scene)
    fast_shading = config.traversal in (Traversal.UNIT, Traversal.PALLAS)
    use_nee = config.nee and scene.n_lights > 0
    if use_nee:
        from gdpathtracing.render import lights as lights_mod
        light_table = lights_mod.build_light_table(scene)

    if use_nee and config.traversal == Traversal.PALLAS:
        from gdpathtracing.ops.intersect_pallas import (
            occluded_pallas, prepare_trace_inputs)
        occ_prep = prepare_trace_inputs(scene)

    def spawn(path_id):
        """Camera ray + RNG stream of path `path_id` — identical to the
        renderer's per-tile spawn (pixel-major within each spp sample)."""
        pix = path_id % n_pix
        s = (path_id // n_pix).astype(jnp.uint32)
        px = (pix % w).astype(jnp.uint32)
        py = (pix // w).astype(jnp.uint32)
        seed = rng.prng_seed(px, py,
                             frame_index * jnp.uint32(config.spp) + s)
        ray, seed = camera.generate_rays(pix, seed, config)
        return ray, seed

    lane0 = jnp.arange(nw, dtype=jnp.int32)
    ray0, seed0 = spawn(lane0)
    zero = jnp.zeros(nw, f32)
    zero3 = Vec3(zero, zero, zero)
    one3 = Vec3(zero + 1.0, zero + 1.0, zero + 1.0)

    compact_lanes = config.compact_rays is not False
    # Retirement log: the permutation groups freshly dead lanes
    # contiguously, so retirement is ONE dynamic_update_slice of their
    # packed columns per iteration. See config.regen_retire.
    use_log = (config.regen_retire == "log" and compact_lanes
               and n_paths < (1 << 24)  # pid rides the log as exact f32
               and 2 * config.bounces + 1 < 32)  # segs fits the pack
    LOG_R = 9  # r g b depth nx ny nz pack(steps*32+segs) pid — steps
    #           and segs share one f32-exact column (steps clamped to
    #           2^19-1 so the pack stays < 2^24) to keep the DATA rows
    #           at 8: the final pid-indexing is then ONE 8-wide row
    #           gather.
    log_len = n_paths + nw

    init = dict(
        next_path=jnp.int32(min(nw, n_paths)),
        nact=jnp.int32(min(nw, n_paths)),
        iters=jnp.int32(0),
        ray_o=ray0.o, ray_d=ray0.d, seed=seed0,
        tp=one3, rad=zero3,
        pid=lane0, bounce=jnp.zeros(nw, jnp.int32),
        active=lane0 < n_paths,
        prev_pdf=zero - 1.0,
        depth1=zero + f32(camera.far), normal1=zero3,
        steps=jnp.zeros(nw, jnp.int32), segs=jnp.zeros(nw, jnp.int32),
    )
    if use_log:
        init.update(log=jnp.zeros((LOG_R, log_len), f32),
                    retired=jnp.int32(0))
    else:
        init.update(out=tuple(jnp.zeros(n_paths, f32)
                              for _ in range(OUT_COLS)))
    # Perf telemetry (return_stats): per-iteration live-lane count and
    # the triangles the trace swept for them (from the HitInfo steps).
    MAX_IT = 96
    if return_stats:
        init.update(it_alive=jnp.zeros(MAX_IT, jnp.int32),
                    it_steps=jnp.zeros(MAX_IT, f32))

    # Tail-coherent spawning: permute the lane state survivors-first each
    # iteration (one packed-row gather), so freshly spawned camera paths
    # fill CONTIGUOUS tail lanes and trace as coherent camera blocks
    # instead of being scattered into incoherent mixed blocks.
    #
    # With sort_lanes the permutation key is Morton-cell-of-origin ×
    # direction-octant (dead last) — the integrator's per-bounce sort,
    # but on an ALWAYS-DENSE wavefront, the best case for per-block chunk
    # culling. It is the PALLAS default.
    sort_lanes = config.sort_rays
    if sort_lanes is None:
        sort_lanes = config.traversal == Traversal.PALLAS
    sort_lanes = bool(sort_lanes) and compact_lanes
    if sort_lanes:
        cb = scene.isect_chunk_bounds
        cell_lo = cb[0:3].min(axis=1)
        cell_span = jnp.maximum(cb[3:6].max(axis=1) - cell_lo, 1e-6)
    use_chunk_key = config.regen_sort_key == "chunk"
    if use_chunk_key:
        key_cb = scene.isect_chunk_bounds
        nc_key = int(key_cb.shape[1])
        if nc_key > 64:
            # Big scenes: key on SUPERCHUNK bounds (the kernel's outer
            # unit of work, and an affordable per-ray slab count).
            from gdpathtracing.ops.intersect_pallas import SCC
            pad = (-nc_key) % SCC
            cbp = jnp.pad(key_cb, ((0, 0), (0, pad)),
                          constant_values=1e30)
            nsc_key = cbp.shape[1] // SCC
            lo = cbp[0:3].reshape(3, nsc_key, SCC).min(axis=2)
            hi = jnp.where(
                cbp[3:6].reshape(3, nsc_key, SCC) > 1e29, -1e30,
                cbp[3:6].reshape(3, nsc_key, SCC)).max(axis=2)
            key_cb = jnp.concatenate(
                [lo, hi, jnp.zeros((2, nsc_key), jnp.float32)], axis=0)
            nc_key = nsc_key

    def first_chunk_key(o, d, alive, fresh):
        """Id of the first chunk (superchunk on big scenes) the ray
        would ENTER (min positive slab tmin over passing boxes) —
        aligns lane blocks with the kernel's actual unit of work so a
        block's rays want the SAME sweeps, not just nearby origins.
        Octant minor; misses/dead last."""
        cb = key_cb
        rdx = 1.0 / jnp.where(jnp.abs(d.x) < 1e-30, 1e-30, d.x)
        rdy = 1.0 / jnp.where(jnp.abs(d.y) < 1e-30, 1e-30, d.y)
        rdz = 1.0 / jnp.where(jnp.abs(d.z) < 1e-30, 1e-30, d.z)
        best_t = jnp.full_like(o.x, jnp.inf)
        best_c = jnp.zeros_like(o.x, dtype=jnp.int32) + nc_key
        for ci in range(nc_key):
            tx1 = (cb[0, ci] - o.x) * rdx
            tx2 = (cb[3, ci] - o.x) * rdx
            ty1 = (cb[1, ci] - o.y) * rdy
            ty2 = (cb[4, ci] - o.y) * rdy
            tz1 = (cb[2, ci] - o.z) * rdz
            tz2 = (cb[5, ci] - o.z) * rdz
            tmin = jnp.maximum(jnp.maximum(jnp.minimum(tx1, tx2),
                                           jnp.minimum(ty1, ty2)),
                               jnp.minimum(tz1, tz2))
            tmax = jnp.minimum(jnp.minimum(jnp.maximum(tx1, tx2),
                                           jnp.maximum(ty1, ty2)),
                               jnp.maximum(tz1, tz2))
            entry = jnp.maximum(tmin, 0.0)
            ok = (tmax >= tmin) & (tmax > 0.0) & (entry < best_t)
            best_t = jnp.where(ok, entry, best_t)
            best_c = jnp.where(ok, ci, best_c)
        octant = ((d.x > 0.0).astype(jnp.int32) * 4
                  + (d.y > 0.0).astype(jnp.int32) * 2
                  + (d.z > 0.0).astype(jnp.int32))
        return jnp.where(alive, best_c * 8 + octant,
                         jnp.where(fresh, 1 << 14, 1 << 15))

    def lane_sort_key(o, d, alive, fresh):
        """Morton(origin cell, 8^3) * 8 + octant(direction); dead keyed
        after every live cell — THREE-way: live cells < freshly-dead
        (this iteration's retirements, which the log write needs as one
        contiguous block) < stale-dead (drain-phase lanes already
        retired earlier) — render/integrator.py's per-bounce key plus
        the retirement split."""
        if use_chunk_key:
            return first_chunk_key(o, d, alive, fresh)
        def q3(x, lo, span):
            return jnp.clip(((x - lo) / span * 8.0).astype(jnp.int32),
                            0, 7)
        qx = q3(o.x, cell_lo[0], cell_span[0])
        qy = q3(o.y, cell_lo[1], cell_span[1])
        qz = q3(o.z, cell_lo[2], cell_span[2])
        cell = jnp.zeros_like(qx)
        for b in range(3):
            cell = cell | (((qx >> b) & 1) << (3 * b + 2)) \
                | (((qy >> b) & 1) << (3 * b + 1)) \
                | (((qz >> b) & 1) << (3 * b))
        octant = ((d.x > 0.0).astype(jnp.int32) * 4
                  + (d.y > 0.0).astype(jnp.int32) * 2
                  + (d.z > 0.0).astype(jnp.int32))
        return jnp.where(alive, cell * 8 + octant,
                         jnp.where(fresh, 1 << 14, 1 << 15))

    def cond(c):
        return (c["next_path"] < n_paths) | jnp.any(c["active"])

    # Two-phase drain: the tail of the frame is straggler-bound — the
    # last-spawned paths need ~max-path-length more iterations while
    # occupancy decays — but per-iteration glue scales with the
    # WAVEFRONT, not the live count. Once the pool is exhausted and the
    # live lanes fit, hand the sorted live prefix to a second while_loop
    # at a smaller static wavefront.
    drain_sizes = []
    if compact_lanes and config.regen_drain is not False:
        dn = config.regen_drain_wavefront
        if dn is None:
            dn = max(256, (nw // 4) // 256 * 256)
        enable = dn < nw and (config.regen_drain is True
                              or n_paths >= 2 * nw)
        if enable:
            drain_sizes = [dn]
            # second, deeper stage: the late tail is straggler-bound
            # (last paths need ~max-path-length more iterations) and
            # glue scales with the static wavefront
            dn2 = max(256, (dn // 4) // 256 * 256)
            if dn2 < dn:
                drain_sizes.append(dn2)

    def cond_for(threshold):
        if threshold is None:
            return cond

        def cond_t(c):
            return (c["next_path"] < n_paths) | (c["nact"] > threshold)
        return cond_t

    def retire(out, mask, pids, vals):
        """Scatter the retired lanes' 9 columns into the 1-D pid-indexed
        output buffers (masked lanes only)."""
        idx = jnp.where(mask, pids, n_paths)
        return tuple(o.at[idx].set(v, mode="drop")
                     for o, v in zip(out, vals))

    def body(c):
        # Shape-generic over the lane count: the two-phase drain runs
        # this same body at a smaller wavefront (traced separately per
        # while_loop, so both specializations are static).
        nw_l = c["pid"].shape[0]
        lane_iota = jnp.arange(nw_l, dtype=jnp.int32)
        ray_o, ray_d = c["ray_o"], c["ray_d"]
        throughput, radiance = c["tp"], c["rad"]
        active, seed = c["active"], c["seed"]
        bounce, prev_pdf = c["bounce"], c["prev_pdf"]
        depth1, normal1 = c["depth1"], c["normal1"]
        steps, segs = c["steps"], c["segs"]

        # ---- one path segment: the standard integrator body ----
        r = Ray(ray_o, ray_d)
        out = None if use_log else c["out"]
        log = c["log"] if use_log else None
        retired = c["retired"] if use_log else None

        def bcf(x):
            # pid rides the f32 log as an exact VALUE cast (pids are
            # < 2^24 — guarded above), not a bitcast: small ints
            # reinterpreted as f32 are denormals, which a flush-to-zero
            # data path would destroy.
            return x.astype(jnp.float32)

        hit = trace_fn(scene, r, active)
        steps = steps + jnp.where(active, hit.steps, 0)
        is_hit = hit.hit & active
        segs = segs + active.astype(jnp.int32)

        if return_stats:
            it = jnp.minimum(c["iters"], MAX_IT - 1)
            stats_upd = dict(
                it_alive=c["it_alive"].at[it].set(
                    jnp.sum(active.astype(jnp.int32))),
                it_steps=c["it_steps"].at[it].set(
                    jnp.sum(jnp.where(active, hit.steps, 0).astype(f32))))
        else:
            stats_upd = {}

        s = get_shading_data(scene, hit, r, fast=fast_shading)
        sky = sample_sky(ray_d, config, scene)
        emission = vwhere(is_hit, s.emission, sky)
        if use_nee:
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
        radiance = vwhere(active, radiance + throughput * emission,
                          radiance)

        if use_nee:
            (lr1, lr2), seed = rng.pcg2d(seed)
            (lr3, _), seed = rng.pcg2d(seed)
            ls = lights_mod.sample_light(light_table, s.position,
                                         lr3, lr1, lr2)
            cos_i = s.normal.dot(ls.wi)
            shadow_o = s.position + s.normal * config.ray_eps
            shadow_active = is_hit & (cos_i > 0.0) & \
                jnp.isfinite(ls.pdf_solid)
            if config.traversal == Traversal.PALLAS:
                occluded = occluded_pallas(scene, Ray(shadow_o, ls.wi),
                                           ls.dist * (1.0 - 1e-3),
                                           shadow_active, prep=occ_prep)
                visibility = (~occluded).astype(jnp.float32)
            else:
                sh = trace_fn(scene, Ray(shadow_o, ls.wi), shadow_active)
                visibility = (~(sh.t < ls.dist * (1.0 - 1e-3))
                              ).astype(jnp.float32)
            segs = segs + shadow_active.astype(jnp.int32)
            f_l = brdf.eval_brdf(s, ls.wi)
            pb_l = brdf.brdf_pdf(s, ls.wi)
            pl_l = ls.pdf_solid
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

        dist = (s.position - ray_o).length()
        first = (bounce == 0) & is_hit
        depth1 = jnp.where(first, dist, depth1)
        normal1 = vwhere(first, s.normal, normal1)

        (r1, r2), seed = rng.pcg2d(seed)
        new_dir = brdf.sample_brdf(s, r1, r2)
        pdf = brdf.brdf_pdf(s, new_dir)
        lambert_in = s.normal.dot(new_dir)
        f = brdf.eval_brdf(s, new_dir)
        scale = jnp.where(pdf > 1e-12,
                          lambert_in / jnp.maximum(pdf, 1e-12), 0.0)
        mult = f * scale
        survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
        offset = s.normal * config.ray_eps
        prev_pdf_val = pdf

        if scene.has_transmission:
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

        new_throughput = throughput * mult

        if config.rr_start > 0:
            (r5, _), seed = rng.pcg2d(seed)
            lum = jnp.maximum(new_throughput.x,
                              jnp.maximum(new_throughput.y,
                                          new_throughput.z))
            p = jnp.clip(lum, config.rr_min_p, 1.0)
            do_rr = bounce >= config.rr_start
            survive = survive & jnp.where(do_rr, r5 < p, True)
            boost = jnp.where(do_rr, 1.0 / p, 1.0)
            new_throughput = new_throughput * boost

        new_o = s.position + offset
        ray_o = vwhere(survive, new_o, ray_o)
        ray_d = vwhere(survive, new_dir, ray_d)
        throughput = vwhere(survive, new_throughput, throughput)
        prev_pdf = jnp.where(survive, prev_pdf_val, -1.0)
        bounce = bounce + active.astype(jnp.int32)
        alive = active & survive & (bounce < config.bounces)

        # ---- retire finished paths ----
        dead_now = active & ~alive
        vals = (radiance.x, radiance.y, radiance.z, depth1,
                normal1.x, normal1.y, normal1.z,
                steps.astype(f32), segs.astype(f32))
        if not use_log:
            out = retire(out, dead_now, c["pid"], vals)

        # ---- survivors-first lane compaction (tail-coherent spawning) ----
        pid = c["pid"]
        if compact_lanes:
            alive_i = alive.astype(jnp.int32)
            n_alive = jnp.sum(alive_i)
            if sort_lanes:
                key = lane_sort_key(ray_o, ray_d, alive, dead_now)
                perm = jnp.argsort(key, stable=True)
            else:
                # 3-way stable partition: alive | fresh-dead | stale
                # (the log write needs this iteration's retirements as
                # one contiguous block right after the survivors).
                fresh_i = dead_now.astype(jnp.int32)
                stale_i = ((~alive) & ~dead_now).astype(jnp.int32)
                ra = jnp.cumsum(alive_i)
                rf = jnp.cumsum(fresh_i)
                rs = jnp.cumsum(stale_i)
                n_fresh_p = rf[-1]
                dest = jnp.where(
                    alive, ra,
                    jnp.where(dead_now, n_alive + rf,
                              n_alive + n_fresh_p + rs)) - 1
                perm = jnp.zeros(nw_l, jnp.int32).at[dest].set(lane_iota)
            # ONE merged row gather for the whole lane state: the 17
            # float + 6 int columns ride a single packed matrix. Carrier
            # dtype is int32: f32 lanes BITCAST to i32 (exact), so ints
            # never transit an f32 data path that could flush denormals.
            bc = jax.lax.bitcast_convert_type
            cols = [ray_o.x, ray_o.y, ray_o.z,
                    ray_d.x, ray_d.y, ray_d.z,
                    throughput.x, throughput.y, throughput.z,
                    radiance.x, radiance.y, radiance.z,
                    prev_pdf, depth1,
                    normal1.x, normal1.y, normal1.z]  # 17 f32
            icols = [bc(seed[0], jnp.int32), bc(seed[1], jnp.int32),
                     pid, bounce, steps, segs]
            m = jnp.stack([bc(x, jnp.int32) for x in cols] + icols,
                          axis=1)[perm]
            NC = len(cols)
            fcol = lambda k: bc(m[:, k], jnp.float32)
            ray_o = Vec3(fcol(0), fcol(1), fcol(2))
            ray_d = Vec3(fcol(3), fcol(4), fcol(5))
            throughput = Vec3(fcol(6), fcol(7), fcol(8))
            radiance = Vec3(fcol(9), fcol(10), fcol(11))
            prev_pdf, depth1 = fcol(12), fcol(13)
            normal1 = Vec3(fcol(14), fcol(15), fcol(16))
            seed = (bc(m[:, NC], jnp.uint32), bc(m[:, NC + 1], jnp.uint32))
            pid, bounce = m[:, NC + 2], m[:, NC + 3]
            steps, segs = m[:, NC + 4], m[:, NC + 5]
            alive = lane_iota < n_alive

        if use_log:
            # v4 retirement: ONE contiguous append of the freshly-dead
            # block (now at [n_alive, n_alive + n_fresh) after the
            # 3-way permutation).
            n_fresh = jnp.sum(dead_now.astype(jnp.int32))
            pack = (jnp.minimum(steps, (1 << 19) - 1) * 32
                    + segs).astype(f32)
            window = jnp.stack(
                [radiance.x, radiance.y, radiance.z, depth1,
                 normal1.x, normal1.y, normal1.z,
                 pack, bcf(pid)], axis=0)
            window = jnp.roll(window, -n_alive, axis=1)
            log = jax.lax.dynamic_update_slice(log, window, (0, retired))
            retired = retired + n_fresh

        # ---- regenerate: refill dead lanes with the next pool paths
        # (post-compaction the dead are the contiguous tail, so fresh
        # consecutive-pixel paths form coherent blocks) ----
        next_path = c["next_path"]
        dead = ~alive
        spawn_rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        new_id = next_path + spawn_rank
        can = dead & (new_id < n_paths)
        new_id = jnp.minimum(new_id, n_paths - 1)
        ray_new, seed_new = spawn(new_id)

        ray_o = vwhere(can, ray_new.o, ray_o)
        ray_d = vwhere(can, ray_new.d, ray_d)
        seed = (jnp.where(can, seed_new[0], seed[0]),
                jnp.where(can, seed_new[1], seed[1]))
        zl = ray_o.x * 0.0  # shape-local (drain phase runs a smaller nw)
        zl3 = Vec3(zl, zl, zl)
        throughput = vwhere(can, Vec3(zl + 1.0, zl + 1.0, zl + 1.0),
                            throughput)
        radiance = vwhere(can, zl3, radiance)
        normal1 = vwhere(can, zl3, normal1)
        depth1 = jnp.where(can, f32(camera.far), depth1)
        prev_pdf = jnp.where(can, -1.0, prev_pdf)
        bounce = jnp.where(can, 0, bounce)
        steps = jnp.where(can, 0, steps)
        segs = jnp.where(can, 0, segs)
        pid = jnp.where(can, new_id, pid)
        active = alive | can
        next_path = jnp.minimum(
            next_path + jnp.sum(dead.astype(jnp.int32)),
            jnp.int32(n_paths))

        new_c = dict(next_path=next_path,
                     nact=jnp.sum(active.astype(jnp.int32)),
                     iters=c["iters"] + 1,
                     ray_o=ray_o, ray_d=ray_d, seed=seed, tp=throughput,
                     rad=radiance, pid=pid, bounce=bounce, active=active,
                     prev_pdf=prev_pdf, depth1=depth1, normal1=normal1,
                     steps=steps, segs=segs, **stats_upd)
        if use_log:
            new_c.update(log=log, retired=retired)
        else:
            new_c["out"] = out
        return new_c

    per_lane = ["ray_o", "ray_d", "seed", "tp", "rad", "pid", "bounce",
                "active", "prev_pdf", "depth1", "normal1", "steps", "segs"]
    final = jax.lax.while_loop(
        cond_for(drain_sizes[0] if drain_sizes else None), body, init)
    for j, dnw in enumerate(drain_sizes):
        nxt = drain_sizes[j + 1] if j + 1 < len(drain_sizes) else None
        init2 = dict(final)
        for k in per_lane:
            init2[k] = jax.tree.map(lambda a, d=dnw: a[:d], final[k])
        final = jax.lax.while_loop(cond_for(nxt), body, init2)
    if use_log:
        # One-shot pid-indexing of the retirement log: every path
        # retired exactly once, so log[:, :n_paths] holds each pid once
        # — scatter positions, transpose the column-major log, and fetch
        # the rows in one 8-wide packed gather.
        log = final["log"]
        pid_l = log[LOG_R - 1, :n_paths].astype(jnp.int32)  # 1-D slice
        pos = jnp.zeros(n_paths, jnp.int32).at[pid_l].set(
            jnp.arange(n_paths, dtype=jnp.int32), mode="drop")
        rows8 = log[0:8, :n_paths].T[pos]       # (n_paths, 8) — ONE gather
        packi = rows8[:, 7].astype(jnp.int32)
        out = tuple(rows8[:, k] for k in range(7)) \
            + ((packi >> 5).astype(f32), (packi & 31).astype(f32))
    else:
        out = final["out"]  # 9 x (n_paths,) pid-indexed directly

    if config.spp > 1:
        o = [a.reshape(config.spp, n_pix) for a in out]
        rgb = jnp.stack([o[0].mean(axis=0), o[1].mean(axis=0),
                         o[2].mean(axis=0)], axis=1)
        depth = o[3].min(axis=0)
        normal = jnp.stack([o[4][0], o[5][0], o[6][0]], axis=1)
        steps = o[7].sum(axis=0)
        segs = o[8].sum(axis=0)
    else:
        rgb = jnp.stack(out[0:3], axis=1)
        depth = out[3]
        normal = jnp.stack(out[4:7], axis=1)
        steps = out[7]
        segs = out[8]
    aovs = FrameAOVs(
        radiance=rgb.reshape(h, w, 3),
        depth=depth.reshape(h, w),
        steps=steps.astype(jnp.int32).reshape(h, w),
        segments=segs.astype(jnp.int32).reshape(h, w),
        normal=normal.reshape(h, w, 3))
    if return_stats:
        return aovs, {"iters": final["iters"],
                      "lane_slots": final["iters"] * nw,
                      "it_alive": final["it_alive"],
                      "it_steps": final["it_steps"]}
    return aovs
