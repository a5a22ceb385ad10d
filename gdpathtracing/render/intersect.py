"""Ray-primitive intersection + the brute-force scene tracer (oracle).

Semantics re-expressed from the reference kernels:
- Möller–Trumbore, no backface cull, |det| epsilon 1e-5
  (main.glsl:224-257);
- slab AABB test returning entry distance or 1e30 on miss
  (main.glsl:259-268);
- the brute-force tracer loops instances × triangle blocks — it is the O(N)
  oracle every BVH backend is tested against (SURVEY.md §4c).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gdpathtracing.core.math3d import affine_apply_dir, affine_apply_point
from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.types import MISS_T, HitInfo, Ray
from gdpathtracing.scene.scene import Scene

DET_EPS = 1e-5  # main.glsl:237
AABB_MISS = 1e30  # main.glsl:267


def moller_trumbore(ray: Ray, v0: Vec3, v1: Vec3, v2: Vec3, t_max):
    """Batched Möller–Trumbore. Broadcasts ray components against triangle
    components. Returns (valid, t, u, v, front)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = ray.d.cross(e2)
    det = e1.dot(pvec)
    inv_det = jnp.where(jnp.abs(det) < DET_EPS, 0.0, 1.0 / det)
    tvec = ray.o - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = ray.d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    valid = (jnp.abs(det) >= DET_EPS) & (u >= 0.0) & (u <= 1.0) & \
            (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < t_max)
    # Front face ⇔ geometric normal faces the incoming ray. (The reference
    # tests dot(geomN, d) > 0 on winding-flipped Godot-imported geometry,
    # main.glsl:255; our data keeps OBJ CCW winding so the sign flips —
    # same faces land front.)
    geom_n = e1.cross(e2)
    front = geom_n.dot(ray.d) < 0.0
    return valid, t, u, v, front


def intersect_aabb(o: Vec3, rcp_d: Vec3, bmin: Vec3, bmax: Vec3):
    """Slab test (main.glsl:259-268): entry distance, or 1e30 on miss."""
    t1 = (bmin - o) * rcp_d
    t2 = (bmax - o) * rcp_d
    tmin = t1.minimum(t2).max_component()
    tmax = t1.maximum(t2).min_component()
    return jnp.where((tmax >= tmin) & (tmax > 0.0), tmin, AABB_MISS)


def _gather_tri(scene: Scene, idx: jnp.ndarray):
    """Gather triangle vertices (clipped) → three Vec3 of idx's shape."""
    tp = scene.tri_pos  # (T, 3, 3)
    v = tp[idx]  # (..., 3, 3) — jnp clips OOB gather indices
    return (Vec3(v[..., 0, 0], v[..., 0, 1], v[..., 0, 2]),
            Vec3(v[..., 1, 0], v[..., 1, 1], v[..., 1, 2]),
            Vec3(v[..., 2, 0], v[..., 2, 1], v[..., 2, 2]))


def trace_brute(scene: Scene, ray: Ray, active=None,
                tri_block: int = 512) -> HitInfo:
    """Closest hit by exhaustive search: python loop over instances
    (static), lax scan over triangle blocks (bounds memory to
    N_rays x tri_block). The oracle all traversal backends are validated
    against.

    `t` stays comparable across instances because object-space directions
    are not renormalized (see HitInfo docstring / main.glsl:320).
    """
    n = ray.o.x.shape[0]
    best = HitInfo.none_like(ray.o.x)

    for inst in range(scene.n_instances):
        inv = scene.inst_inv_transform[inst]  # (3,4)
        o_obj = affine_apply_point(inv, ray.o)
        d_obj = affine_apply_dir(inv, ray.d)
        r_obj = Ray(o_obj, d_obj)
        first = scene.inst_tri_first[inst]   # static python ints
        count = scene.inst_tri_count[inst]
        n_blocks = -(-count // tri_block)

        def body(carry, blk, first=first, count=count, r_obj=r_obj,
                 inst=inst):
            best = carry
            tri_idx = first + blk * tri_block + jnp.arange(tri_block)
            tri_ok = tri_idx < first + count
            v0, v1, v2 = _gather_tri(scene, tri_idx)  # (B,) components
            # Broadcast rays (N,1) against triangles (B,).
            rr = Ray(Vec3(r_obj.o.x[:, None], r_obj.o.y[:, None],
                          r_obj.o.z[:, None]),
                     Vec3(r_obj.d.x[:, None], r_obj.d.y[:, None],
                          r_obj.d.z[:, None]))
            valid, t, u, v, front = moller_trumbore(
                rr, v0, v1, v2, best.t[:, None])
            valid = valid & tri_ok[None, :]
            t = jnp.where(valid, t, MISS_T)
            k = jnp.argmin(t, axis=1)
            row = jnp.arange(n)
            better = t[row, k] < best.t
            upd = lambda new, old: jnp.where(better, new, old)
            best = HitInfo(
                t=upd(t[row, k], best.t),
                tri=upd(tri_idx[k].astype(jnp.int32), best.tri),
                inst=upd(jnp.int32(inst), best.inst),
                u=upd(u[row, k], best.u),
                v=upd(v[row, k], best.v),
                front=jnp.where(better, front[row, k], best.front),
                steps=best.steps + jnp.sum(tri_ok).astype(jnp.int32),
                eidx=best.eidx,
            )
            return best, None

        best, _ = jax.lax.scan(body, best, jnp.arange(n_blocks))

    if active is not None:
        best = best._replace(t=jnp.where(active, best.t, MISS_T))
    return best


def occlusion_soft(scene: Scene, ray: Ray, t_max, active=None,
                   edge_eps: float = 2e-2, chunk: int = 512) -> jnp.ndarray:
    """Differentiable soft visibility for shadow rays in [0, 1]:
    ``V = prod_i (1 - sigmoid(margin_i / edge_eps))`` over all triangles
    the ray passes within `edge_eps` (barycentric units) of — the
    SoftRas-style silhouette relaxation applied to ray-traced shadows.

    As ``edge_eps -> 0`` this recovers hard visibility; for small eps it
    yields consistent gradients of shadows w.r.t. BLOCKER geometry
    (vertices / instance transforms, via the in-graph isect tables of
    scene/dynamic.py), which the hard-visibility estimator drops entirely
    (the missing silhouette/boundary term of the transport derivative).
    Bias is O(edge_eps) and confined to silhouette bands. No reference
    counterpart (the reference is non-differentiable); this is the
    visibility half of BASELINE config 4."""
    e = scene.isect_mu.shape[1]
    chunk = min(chunk, e)
    if e % chunk:
        chunk = 256  # E is always a 256-multiple; overlap would make the
        #              visibility product double-count boundary triangles
    n_chunks = e // chunk

    # Expanded per-triangle edge openness (Scene.tri_edge_open): only OPEN
    # (mesh-boundary) edges soften; interior seams (a quad's diagonal, a
    # box crease) stay hard, so a ray crossing a seam sees full coverage
    # from the triangle it is inside instead of 2x sigmoid(0) light leak.
    eo = scene.tri_edge_open[scene.isect_tri].T  # (3, E)

    o4 = jnp.stack([ray.o.x, ray.o.y, ray.o.z,
                    jnp.ones_like(ray.o.x)], axis=1)  # (N, 4)
    d4 = jnp.stack([ray.d.x, ray.d.y, ray.d.z,
                    jnp.zeros_like(ray.d.x)], axis=1)

    def body(vis, ci):
        sl = ci * chunk
        mu = jax.lax.dynamic_slice(scene.isect_mu, (0, sl), (4, chunk))
        mv = jax.lax.dynamic_slice(scene.isect_mv, (0, sl), (4, chunk))
        mw = jax.lax.dynamic_slice(scene.isect_mw, (0, sl), (4, chunk))
        eoc = jax.lax.dynamic_slice(eo, (0, sl), (3, chunk))

        def mm(a, m):
            return jax.lax.dot_general(
                a, m, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)

        u_o, v_o, w_o = mm(o4, mu), mm(o4, mv), mm(o4, mw)
        u_d, v_d, w_d = mm(d4, mu), mm(d4, mv), mm(d4, mw)
        wd_ok = jnp.abs(w_d) > 1e-12
        inv_wd = jnp.where(wd_ok, 1.0 / jnp.where(wd_ok, w_d, 1.0), 0.0)
        t = -w_o * inv_wd
        u = u_o + t * u_d
        v = v_o + t * v_d
        # Signed inside-distance in barycentric coordinates: positive
        # inside the triangle, negative outside; zero ON an edge. Only
        # OPEN edges soften — interior-edge distances gate hard instead
        # (crossing a seam hands coverage to the neighbor triangle).
        w_ = 1.0 - u - v
        ou, ov, ow = eoc[0][None, :], eoc[1][None, :], eoc[2][None, :]
        m_open = jnp.minimum(
            jnp.minimum(jnp.where(ou > 0, u, 1.0),
                        jnp.where(ov > 0, v, 1.0)),
            jnp.where(ow > 0, w_, 1.0))
        int_ok = jnp.minimum(
            jnp.minimum(jnp.where(ou > 0, 1.0, u),
                        jnp.where(ov > 0, 1.0, v)),
            jnp.where(ow > 0, 1.0, w_)) > 0.0
        cov = jax.nn.sigmoid(m_open / edge_eps)
        in_t = wd_ok & (t > 1e-6) & (t < t_max[:, None]) & int_ok
        cov = jnp.where(in_t, cov, 0.0)
        vis = vis * jnp.prod(1.0 - cov, axis=1)
        return vis, None

    vis, _ = jax.lax.scan(body, jnp.ones_like(ray.o.x),
                          jnp.arange(n_chunks))
    if active is not None:
        vis = jnp.where(active, vis, 1.0)
    return vis


def trace_unit(scene: Scene, ray: Ray, active=None,
               chunk: int = 512) -> HitInfo:
    """Closest hit via unit-triangle-space matmuls over the
    instance-expanded world-space triangle list (Scene.isect_*).

    Two (N,4)x(4,C) contractions per chunk (at HIGHEST precision, never
    TF32) + elementwise epilogue instead of per-pair cross products.
    Pure-JAX version; ops/intersect_pallas.py fuses the same math into a
    kernel that keeps the (rays × triangles) intermediates in registers.
    """
    n = ray.o.x.shape[0]
    e = scene.isect_mu.shape[1]
    chunk = min(chunk, e)
    n_chunks = e // chunk if e % chunk == 0 else -(-e // chunk)

    o4 = jnp.stack([ray.o.x, ray.o.y, ray.o.z,
                    jnp.ones_like(ray.o.x)], axis=1)  # (N, 4)
    d4 = jnp.stack([ray.d.x, ray.d.y, ray.d.z,
                    jnp.zeros_like(ray.d.x)], axis=1)

    best_t = ray.o.x * 0.0 + MISS_T
    best_e = (ray.o.x * 0.0).astype(jnp.int32)
    best_u = ray.o.x * 0.0
    best_v = ray.o.x * 0.0
    best_front = best_e.astype(bool)

    def body(carry, ci):
        best_t, best_e, best_u, best_v, best_front = carry
        sl = ci * chunk
        mu = jax.lax.dynamic_slice(scene.isect_mu, (0, sl), (4, chunk))
        mv = jax.lax.dynamic_slice(scene.isect_mv, (0, sl), (4, chunk))
        mw = jax.lax.dynamic_slice(scene.isect_mw, (0, sl), (4, chunk))

        def mm(a, m):
            return jax.lax.dot_general(
                a, m, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)

        u_o, v_o, w_o = mm(o4, mu), mm(o4, mv), mm(o4, mw)
        u_d, v_d, w_d = mm(d4, mu), mm(d4, mv), mm(d4, mw)
        inv_wd = jnp.where(jnp.abs(w_d) > 1e-12, 1.0 / w_d, 0.0)
        t = -w_o * inv_wd
        u = u_o + t * u_d
        v = v_o + t * v_d
        valid = (jnp.abs(w_d) > 1e-12) & (t > 0.0) & (u >= 0.0) & \
            (v >= 0.0) & (u + v <= 1.0) & (t < best_t[:, None])
        t = jnp.where(valid, t, MISS_T)
        k = jnp.argmin(t, axis=1)
        row = jnp.arange(n)
        tk = t[row, k]
        better = tk < best_t
        ei = (sl + k).astype(jnp.int32)
        best = (
            jnp.where(better, tk, best_t),
            jnp.where(better, ei, best_e),
            jnp.where(better, u[row, k], best_u),
            jnp.where(better, v[row, k], best_v),
            jnp.where(better, w_d[row, k] < 0.0, best_front),
        )
        return best, None

    (best_t, best_e, best_u, best_v, best_front), _ = jax.lax.scan(
        body, (best_t, best_e, best_u, best_v, best_front),
        jnp.arange(n_chunks))

    hit = best_t < MISS_T
    tri = jnp.where(hit, scene.isect_tri[best_e], 0)
    inst = jnp.where(hit, scene.isect_inst[best_e], 0)
    steps = (ray.o.x * 0.0).astype(jnp.int32) + e
    if active is not None:
        best_t = jnp.where(active, best_t, MISS_T)
    return HitInfo(t=best_t, tri=tri, inst=inst, u=best_u, v=best_v,
                   front=best_front, steps=steps, eidx=best_e)
