"""Dynamic scenes without host round-trips (SURVEY.md §7 step 8).

The reference rebuilds nothing per frame (static scenes only); here moving
instances and deforming meshes are first-class:

- ``update_instance_transforms(scene, transforms)`` — fully jit-able
  Scene→Scene: recomputes instance inverses, the instance-expanded
  unit-triangle intersection tables (device Morton re-sort included),
  chunk AABBs, and refits the TLAS. Array shapes are unchanged, so the
  render step does not retrace.
- ``refit_blas(scene)`` — refits BLAS node AABBs bottom-up after vertex
  deformation (``replace_vertices``), keeping topology.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gdpathtracing.scene.scene import ISECT_CHUNK, Scene, build_shade_rows


def _spread_bits(v: jnp.ndarray) -> jnp.ndarray:
    v = v.astype(jnp.uint32)
    v = (v | (v << 16)) & jnp.uint32(0x30000FF)
    v = (v | (v << 8)) & jnp.uint32(0x300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x30C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x9249249)
    return v


def morton_codes(points: jnp.ndarray, lo, span) -> jnp.ndarray:
    """(n, 3) f32 → 30-bit Morton codes (uint32)."""
    q = jnp.clip((points - lo) / span * 1023.0, 0.0, 1023.0).astype(jnp.uint32)
    return (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << jnp.uint32(1))
            | (_spread_bits(q[:, 2]) << jnp.uint32(2)))


def _affine_inverse_batch(tf: jnp.ndarray) -> jnp.ndarray:
    """(I, 3, 4) → (I, 3, 4) inverse affines."""
    with jax.default_matmul_precision("float32"):
        r_inv = jnp.linalg.inv(tf[:, :, :3])
        t = -jnp.einsum("iab,ib->ia", r_inv, tf[:, :, 3])
    return jnp.concatenate([r_inv, t[:, :, None]], axis=2)


def update_instance_transforms(scene: Scene,
                               transforms: jnp.ndarray) -> Scene:
    """Move instances: new (I, 3, 4) world-from-object affines. Jit-able."""
    transforms = jnp.asarray(transforms, jnp.float32)
    inv = _affine_inverse_batch(transforms)

    # --- rebuild expanded world-space triangle tables on device ---
    tri = scene.tri_pos[scene.isect_tri]          # (E, 3, 3) object space
    tf_e = transforms[scene.isect_inst]           # (E, 3, 4)
    world = jnp.einsum("eab,evb->eva", tf_e[:, :, :3], tri) + \
        tf_e[:, None, :, 3]
    w0 = world[:, 0]
    e1 = world[:, 1] - w0
    e2 = world[:, 2] - w0
    n = jnp.cross(e1, e2)
    m = jnp.stack([e1, e2, n], axis=-1)           # (E, 3, 3) columns
    det = jnp.linalg.det(m)
    ok = jnp.abs(det) > 1e-18
    eye = jnp.eye(3, dtype=jnp.float32)
    m_safe = jnp.where(ok[:, None, None], m, eye)
    with jax.default_matmul_precision("float32"):
        minv = jnp.linalg.inv(m_safe)
    minv = jnp.where(ok[:, None, None], minv, 0.0)
    c = -jnp.einsum("eab,eb->ea", minv, w0)
    cols = jnp.concatenate([minv, c[:, :, None]], axis=2)  # (E, 3, 4)

    # --- device Morton re-sort (the LBVH ordering pass, jax.lax sort) ---
    cent = world.mean(axis=1)
    lo = cent.min(axis=0)
    span = jnp.maximum(cent.max(axis=0) - lo, 1e-12)
    codes = morton_codes(cent, lo, span)
    order = jnp.argsort(codes)
    cols = cols[order]
    world = world[order]
    inst_ids = scene.isect_inst[order]
    tri_ids = scene.isect_tri[order]
    light_ids = scene.isect_light[order]  # (inst, tri) → light map permutes

    e_pad = scene.isect_mu.shape[1]
    n_chunks = e_pad // ISECT_CHUNK
    wc = world.reshape(n_chunks, -1, 3)
    chunk_bounds = jnp.zeros((8, n_chunks), jnp.float32)
    chunk_bounds = chunk_bounds.at[0:3].set(wc.min(axis=1).T)
    chunk_bounds = chunk_bounds.at[3:6].set(wc.max(axis=1).T)

    mu = cols[:, 0, :].T
    mv = cols[:, 1, :].T
    mw = cols[:, 2, :].T

    # --- TLAS refit: leaf AABBs from transformed BLAS root corners ---
    root_min = scene.node_min[scene.inst_root]    # (I, 3)
    root_max = scene.node_max[scene.inst_root]
    corners = jnp.stack([
        jnp.stack([jnp.where(jnp.bool_((k >> a) & 1), root_max[:, a],
                             root_min[:, a]) for a in range(3)], axis=-1)
        for k in range(8)], axis=1)               # (I, 8, 3)
    wcorners = jnp.einsum("iab,ikb->ika", transforms[:, :, :3], corners) + \
        transforms[:, None, :, 3]
    inst_min = wcorners.min(axis=1)
    inst_max = wcorners.max(axis=1)

    n_inst = scene.n_instances
    leaf_ids = jnp.arange(1, 1 + n_inst)
    tlas_min = scene.tlas_min.at[leaf_ids].set(inst_min)
    tlas_max = scene.tlas_max.at[leaf_ids].set(inst_max)
    if scene.tlas_refit_order:
        for i in scene.tlas_refit_order:  # static, children-first
            l = scene.tlas_left[i]
            r = scene.tlas_right[i]
            tlas_min = tlas_min.at[i].set(
                jnp.minimum(tlas_min[l], tlas_min[r]))
            tlas_max = tlas_max.at[i].set(
                jnp.maximum(tlas_max[l], tlas_max[r]))
    else:  # single-instance TLAS: slot 0 IS the leaf copy
        tlas_min = tlas_min.at[0].set(inst_min[0])
        tlas_max = tlas_max.at[0].set(inst_max[0])

    shade = build_shade_rows(scene.tri_normal, scene.tri_uv,
                             scene.tri_slot, scene.inst_materials,
                             transforms, inst_ids, tri_ids)
    return dataclasses.replace(
        scene,
        inst_transform=transforms,
        inst_inv_transform=inv,
        isect_mu=mu, isect_mv=mv, isect_mw=mw,
        isect_cols=jnp.concatenate([mu.T, mv.T, mw.T], axis=1),
        isect_inst=inst_ids, isect_tri=tri_ids,
        isect_light=light_ids,
        isect_chunk_bounds=chunk_bounds,
        isect_shade=shade,
        tlas_min=tlas_min, tlas_max=tlas_max,
    )


def refit_blas(scene: Scene) -> Scene:
    """Refit BLAS node AABBs after ``tri_pos`` deformation (topology
    kept). Iterative bottom-up sweep: leaves pull from triangles, then
    repeated parent passes until the deepest path is covered."""
    tri_min = scene.tri_pos.min(axis=1)
    tri_max = scene.tri_pos.max(axis=1)

    is_leaf = scene.node_count > 0
    b = scene.node_min.shape[0]
    # Leaf AABBs: segment min over [first, first+count). count ≤ 4 → static
    # 4-wide masked reduction.
    first = scene.node_first
    count = scene.node_count
    lmin = jnp.full((b, 3), jnp.inf, jnp.float32)
    lmax = jnp.full((b, 3), -jnp.inf, jnp.float32)
    for k in range(4):
        sel = (k < count)[:, None]
        idx = jnp.minimum(first + k, tri_min.shape[0] - 1)
        lmin = jnp.where(sel, jnp.minimum(lmin, tri_min[idx]), lmin)
        lmax = jnp.where(sel, jnp.maximum(lmax, tri_max[idx]), lmax)

    node_min = jnp.where(is_leaf[:, None], lmin, scene.node_min)
    node_max = jnp.where(is_leaf[:, None], lmax, scene.node_max)

    # Internal nodes: fixed-point parent sweeps; depth ≤ ~2·log2(T).
    import math
    depth = max(2 * math.ceil(math.log2(max(scene.n_tris, 2))) + 2, 4)

    def body(_, mm):
        node_min, node_max = mm
        l = scene.node_left
        r = scene.node_right
        new_min = jnp.minimum(node_min[l], node_min[r])
        new_max = jnp.maximum(node_max[l], node_max[r])
        node_min = jnp.where(is_leaf[:, None], node_min, new_min)
        node_max = jnp.where(is_leaf[:, None], node_max, new_max)
        return node_min, node_max

    node_min, node_max = jax.lax.fori_loop(0, depth, body,
                                           (node_min, node_max))
    return dataclasses.replace(scene, node_min=node_min, node_max=node_max)


def update_vertices(scene: Scene, tri_pos: jnp.ndarray) -> Scene:
    """Deform mesh vertices: refit the BLAS and rebuild the world-space
    intersection tables + TLAS (jit-able)."""
    scene = dataclasses.replace(scene, tri_pos=jnp.asarray(tri_pos,
                                                           jnp.float32))
    scene = refit_blas(scene)
    return update_instance_transforms(scene, scene.inst_transform)
