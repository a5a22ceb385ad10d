"""Batched two-level (TLAS→BLAS) BVH traversal in pure JAX.

Wavefront re-design of the reference's per-thread stack traversal
(ray_trace_tlas / ray_trace_blas, main.glsl:270-350). The reference gives
every ray its own scalar program + stack; in plain JAX the WHOLE wavefront
advances in lockstep through ONE ``lax.while_loop``:

- Each ray owns one packed uint32 stack lane of depth ``max_stack``
  (the analog of the 64-deep local stack at main.glsl:272,307).
- The two hierarchy levels are UNIFIED into a single loop: a stack entry is
  ``(inst+1) << NODE_BITS | node`` — tag 0 means "TLAS node", otherwise a
  BLAS node of instance ``inst``. Popping a TLAS leaf pushes the instance's
  BLAS root with its tag; BLAS entries transform the ray into object space
  on the fly. This removes the nested-loop divergence that a literal
  translation would hit (the reference re-enters a second while loop per
  TLAS leaf, main.glsl:322).
- Ordered near-child-first descent with far-child-first pushes and
  ``t``-culling, exactly the reference's scheme (main.glsl:293-299).
- Leaf intersection is a fixed 4-wide masked Möller–Trumbore (the builder
  guarantees ≤ 4 tris/leaf, bvh.cpp:125), so the loop body is fully static.

Rays idle (masked) once their stack empties; the loop ends when every
stack is empty. This wastes lanes on divergence — the Pallas backend and
BVH widening attack that; this version is the correctness baseline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gdpathtracing.core.math3d import affine_apply_dir, affine_apply_point
from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.intersect import intersect_aabb, moller_trumbore
from gdpathtracing.render.types import MISS_T, HitInfo, Ray
from gdpathtracing.scene.scene import Scene

NODE_BITS = 21
NODE_MASK = jnp.uint32((1 << NODE_BITS) - 1)
MAX_LEAF = 4


def trace_bvh(scene: Scene, ray: Ray, active=None, max_stack: int = 64,
              max_iters: int = 1 << 20) -> HitInfo:
    """Closest hit for the wavefront `ray` ((N,) component SoA)."""
    n = ray.o.x.shape[0]
    row = jnp.arange(n)
    lane = jnp.arange(max_stack, dtype=jnp.int32)

    rcp_w = ray.rcp_d()

    # All loop carries are derived arithmetically from `ray` so they carry
    # its varying-axes type under shard_map (see HitInfo.none_like).
    zero_n = (ray.o.x * 0.0).astype(jnp.int32)
    if active is None:
        active0 = zero_n.astype(bool) | True
    else:
        active0 = active

    stack = (zero_n.astype(jnp.uint32))[:, None] + \
        jnp.zeros((1, max_stack), dtype=jnp.uint32)
    # Root entry = TLAS node 0 (tag 0) — already the zero word; start with
    # ptr=1 for live rays.
    ptr = jnp.where(active0, 1, 0).astype(jnp.int32)
    best = HitInfo.none_like(ray.o.x)

    def cond(state):
        it, ptr, stack, best = state
        return (it < max_iters) & jnp.any(ptr > 0)

    def body(state):
        it, ptr, stack, best = state
        live = ptr > 0
        idx = jnp.maximum(ptr - 1, 0)
        entry = stack[row, idx]
        ptr = jnp.where(live, ptr - 1, ptr)

        tag = (entry >> NODE_BITS).astype(jnp.int32)
        node = (entry & NODE_MASK).astype(jnp.int32)
        is_tlas = tag == 0
        inst = jnp.maximum(tag - 1, 0)

        # ---------- TLAS side ----------
        t_left = scene.tlas_left[node]
        t_right = scene.tlas_right[node]
        tlas_leaf = is_tlas & (t_left == 0)
        tlas_internal = is_tlas & (t_left != 0)
        # children slab tests in world space
        tl_min = Vec3.from_array(scene.tlas_min[t_left])
        tl_max = Vec3.from_array(scene.tlas_max[t_left])
        tr_min = Vec3.from_array(scene.tlas_min[t_right])
        tr_max = Vec3.from_array(scene.tlas_max[t_right])
        t_dl = intersect_aabb(ray.o, rcp_w, tl_min, tl_max)
        t_dr = intersect_aabb(ray.o, rcp_w, tr_min, tr_max)
        # TLAS leaf → push instance's BLAS root, tagged.
        leaf_inst = scene.tlas_inst[node]
        blas_root_entry = ((leaf_inst + 1).astype(jnp.uint32) << NODE_BITS) \
            | scene.inst_root[leaf_inst].astype(jnp.uint32)

        # ---------- BLAS side ----------
        inv = scene.inst_inv_transform[inst]          # (N, 3, 4)
        o_obj = affine_apply_point(inv, ray.o)
        d_obj = affine_apply_dir(inv, ray.d)
        rcp_o = Vec3(1.0 / d_obj.x, 1.0 / d_obj.y, 1.0 / d_obj.z)
        b_left = scene.node_left[node]
        b_right = scene.node_right[node]
        b_first = scene.node_first[node]
        b_count = scene.node_count[node]
        blas_leaf = (~is_tlas) & (b_count > 0)
        blas_internal = (~is_tlas) & (b_count == 0)
        bl_min = Vec3.from_array(scene.node_min[b_left])
        bl_max = Vec3.from_array(scene.node_max[b_left])
        br_min = Vec3.from_array(scene.node_min[b_right])
        br_max = Vec3.from_array(scene.node_max[b_right])
        b_dl = intersect_aabb(o_obj, rcp_o, bl_min, bl_max)
        b_dr = intersect_aabb(o_obj, rcp_o, br_min, br_max)

        # ---------- leaf: fixed 4-wide triangle test ----------
        r_obj = Ray(o_obj, d_obj)
        t_best = best.t
        new_best = best
        do_tri = live & blas_leaf
        for k in range(MAX_LEAF):
            tri_idx = b_first + k
            tri_live = do_tri & (k < b_count)
            tvert = scene.tri_pos[tri_idx]  # (N, 3, 3)
            v0 = Vec3(tvert[:, 0, 0], tvert[:, 0, 1], tvert[:, 0, 2])
            v1 = Vec3(tvert[:, 1, 0], tvert[:, 1, 1], tvert[:, 1, 2])
            v2 = Vec3(tvert[:, 2, 0], tvert[:, 2, 1], tvert[:, 2, 2])
            ok, t, u, v, front = moller_trumbore(r_obj, v0, v1, v2,
                                                 new_best.t)
            upd = tri_live & ok
            new_best = HitInfo(
                t=jnp.where(upd, t, new_best.t),
                tri=jnp.where(upd, tri_idx, new_best.tri),
                inst=jnp.where(upd, inst, new_best.inst),
                u=jnp.where(upd, u, new_best.u),
                v=jnp.where(upd, v, new_best.v),
                front=jnp.where(upd, front, new_best.front),
                steps=new_best.steps + tri_live.astype(jnp.int32),
                eidx=new_best.eidx,
            )
        best = new_best

        # ---------- ordered pushes (far first, near on top) ----------
        internal = live & (tlas_internal | blas_internal)
        dl = jnp.where(is_tlas, t_dl, b_dl)
        dr = jnp.where(is_tlas, t_dr, b_dr)
        left_entry = jnp.where(
            is_tlas, t_left.astype(jnp.uint32),
            (tag.astype(jnp.uint32) << NODE_BITS) | b_left.astype(jnp.uint32))
        right_entry = jnp.where(
            is_tlas, t_right.astype(jnp.uint32),
            (tag.astype(jnp.uint32) << NODE_BITS) | b_right.astype(jnp.uint32))
        left_valid = internal & (dl < best.t)
        right_valid = internal & (dr < best.t)
        left_near = dl < dr
        near_entry = jnp.where(left_near, left_entry, right_entry)
        far_entry = jnp.where(left_near, right_entry, left_entry)
        near_valid = jnp.where(left_near, left_valid, right_valid)
        far_valid = jnp.where(left_near, right_valid, left_valid)

        # TLAS leaf pushes its BLAS root as the "near" slot.
        push_leaf = live & tlas_leaf
        near_entry = jnp.where(push_leaf, blas_root_entry, near_entry)
        near_valid = near_valid | push_leaf

        # Scatter: far then near (near popped first).
        sel_far = (lane[None, :] == ptr[:, None]) & far_valid[:, None]
        stack = jnp.where(sel_far, far_entry[:, None], stack)
        ptr = ptr + far_valid.astype(jnp.int32)
        sel_near = (lane[None, :] == ptr[:, None]) & near_valid[:, None]
        stack = jnp.where(sel_near, near_entry[:, None], stack)
        ptr = ptr + near_valid.astype(jnp.int32)

        return (it + 1, ptr, stack, best)

    _, _, _, best = jax.lax.while_loop(
        cond, body, (jnp.int32(0), ptr, stack, best))

    if active is not None:
        best = best._replace(t=jnp.where(active, best.t, MISS_T))
    return best
