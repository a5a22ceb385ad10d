"""Hit → shading data: barycentric interpolation, instance transforms,
material fetch, texture-array sampling.

Analog of get_shading_data (main.glsl:194-222) plus the sampler2DArray
bilinear fetch (main.glsl:155, 213-214). Fully gather-based over the
wavefront; every lookup is masked-safe (indices clipped).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gdpathtracing.core.math3d import affine_apply_dir, affine_apply_point
from gdpathtracing.core.vec import Vec3, where as vwhere
from gdpathtracing.render.types import HitInfo, Ray, ShadingInfo
from gdpathtracing.scene.scene import Scene

MIN_ROUGHNESS = 0.006  # main.glsl:219


def sample_texture_array(textures: jnp.ndarray, tex_idx: jnp.ndarray,
                         u: jnp.ndarray, v: jnp.ndarray) -> Vec3:
    """Bilinear sample of (X, R, R, 3) with repeat wrapping; tex_idx < 0
    returns white (untextured, geometry_group3d.cpp conversion uses -1)."""
    res = textures.shape[1]
    fu = (u % 1.0) * res - 0.5
    fv = (v % 1.0) * res - 0.5
    x0 = jnp.floor(fu).astype(jnp.int32)
    y0 = jnp.floor(fv).astype(jnp.int32)
    fx = fu - x0
    fy = fv - y0
    x0w = x0 % res
    y0w = y0 % res
    x1w = (x0 + 1) % res
    y1w = (y0 + 1) % res
    t = jnp.maximum(tex_idx, 0)

    def fetch(yy, xx):
        c = textures[t, yy, xx]  # (N, 3)
        return Vec3(c[..., 0], c[..., 1], c[..., 2])

    c00 = fetch(y0w, x0w)
    c01 = fetch(y0w, x1w)
    c10 = fetch(y1w, x0w)
    c11 = fetch(y1w, x1w)
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    color = top + (bot - top) * fy
    untextured = tex_idx < 0
    one = Vec3.full(1.0)
    return vwhere(untextured, one, color)


def get_shading_data_fast(scene: Scene, hit: HitInfo, ray: Ray
                          ) -> ShadingInfo:
    """Packed-row shading fetch for backends that report the expanded
    triangle index (unit/pallas): ONE (N, 16) gather from isect_shade plus
    one small (N, 13) fetch from the live material arrays instead of ~12
    separate gathers in the classic path. Same math as get_shading_data."""
    e = jnp.maximum(hit.eidx, 0)
    row = scene.isect_shade[e]               # (N, 16)
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    normal = Vec3(
        row[:, 0] * w + row[:, 3] * u + row[:, 6] * v,
        row[:, 1] * w + row[:, 4] * u + row[:, 7] * v,
        row[:, 2] * w + row[:, 5] * u + row[:, 8] * v,
    ).normalize(eps=1e-20)
    normal = vwhere(hit.front, normal, -normal)
    uv_u = row[:, 9] * w + row[:, 11] * u + row[:, 13] * v
    uv_v = row[:, 10] * w + row[:, 12] * u + row[:, 14] * v
    mat_id = row[:, 15].astype(jnp.int32)

    # Live material arrays (kept separate so albedo/emission gradients
    # flow); packed to one small (M, 13) table. For small M the per-ray
    # fetch is a ONE-HOT MATMUL, not a gather: bit-exact at HIGHEST
    # precision (never TF32: one-hot rows must select f32 values
    # exactly), and its vjp is onehotᵀ·ḡ, another matmul, where the
    # gather's vjp is an (N, 13) scatter-add. Large M keeps the gather
    # (an (N, M) one-hot would dwarf the gather's traffic).
    mat_tbl = jnp.concatenate([
        scene.mat_albedo, scene.mat_emission,
        scene.mat_emission_energy[:, None], scene.mat_metallic[:, None],
        scene.mat_roughness[:, None],
        scene.mat_tex.astype(jnp.float32)[:, None],
        scene.mat_transmission[:, None],
        scene.mat_ior[:, None],
        scene.mat_mr_tex.astype(jnp.float32)[:, None]], axis=1)
    m = mat_tbl.shape[0]
    if m <= 128:
        onehot = (mat_id[:, None] == jnp.arange(m, dtype=jnp.int32)[None, :]
                  ).astype(jnp.float32)
        mat_rows = jax.lax.dot_general(
            onehot, mat_tbl, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
    else:
        mat_rows = mat_tbl[mat_id]
    albedo = Vec3(mat_rows[:, 0], mat_rows[:, 1], mat_rows[:, 2])
    if scene.has_textures:  # static: skip the 4 bilinear gathers otherwise
        tex_idx = mat_rows[:, 9].astype(jnp.int32)
        albedo = albedo * sample_texture_array(scene.textures, tex_idx,
                                               uv_u, uv_v)
    energy = jnp.maximum(0.0, mat_rows[:, 6])
    emission = Vec3(mat_rows[:, 3] * energy, mat_rows[:, 4] * energy,
                    mat_rows[:, 5] * energy)
    metallic = mat_rows[:, 7]
    roughness = mat_rows[:, 8]
    if scene.has_mr_textures:
        mr_idx = mat_rows[:, 12].astype(jnp.int32)
        mr = sample_texture_array(scene.textures, mr_idx, uv_u, uv_v)
        roughness = jnp.where(mr_idx >= 0, roughness * mr.y, roughness)
        metallic = jnp.where(mr_idx >= 0, metallic * mr.z, metallic)
    position = ray.at(hit.t)
    out_dir = -ray.d
    fresnel_0 = Vec3.full(0.02, like=albedo) + \
        (albedo - Vec3.full(0.02, like=albedo)) * metallic
    diffuse_albedo = albedo - albedo * metallic
    roughness = jnp.maximum(MIN_ROUGHNESS, roughness)
    return ShadingInfo(
        position=position, normal=normal, out_dir=out_dir,
        lambert_out=normal.dot(out_dir), emission=emission,
        diffuse_albedo=diffuse_albedo, fresnel_0=fresnel_0,
        roughness=roughness,
        transmission=mat_rows[:, 10], ior=mat_rows[:, 11], albedo=albedo)


def get_shading_data(scene: Scene, hit: HitInfo, ray: Ray,
                     fast: bool = False) -> ShadingInfo:
    """main.glsl:194-222. `ray` is the world-space ray (out_dir = -d is
    already world-space here, unlike the reference which stores an
    object-space out_dir and re-transforms it at main.glsl:201 — same
    result, one transform cheaper)."""
    if fast:
        return get_shading_data_fast(scene, hit, ray)
    tri = hit.tri
    inst = hit.inst

    # Per-surface material id via the instance's material table
    # (main.glsl:198) — the one-mesh-many-materials instancing mechanism.
    slot = scene.tri_slot[tri]
    slot = jnp.minimum(slot, scene.inst_materials.shape[1] - 1)
    mat_id = scene.inst_materials[inst, slot]

    tf = scene.inst_transform[inst]  # (N, 3, 4)

    u, v = hit.u, hit.v
    w = 1.0 - u - v

    nrm = scene.tri_normal[tri]  # (N, 3, 3)
    n_obj = Vec3(
        nrm[..., 0, 0] * w + nrm[..., 1, 0] * u + nrm[..., 2, 0] * v,
        nrm[..., 0, 1] * w + nrm[..., 1, 1] * u + nrm[..., 2, 1] * v,
        nrm[..., 0, 2] * w + nrm[..., 1, 2] * u + nrm[..., 2, 2] * v,
    )
    uvs = scene.tri_uv[tri]  # (N, 3, 2)
    uv_u = uvs[..., 0, 0] * w + uvs[..., 1, 0] * u + uvs[..., 2, 0] * v
    uv_v = uvs[..., 0, 1] * w + uvs[..., 1, 1] * u + uvs[..., 2, 1] * v

    # Hit position: recompute in object space then transform (main.glsl:200)
    # — equivalently o_world + t*d_world since t is instance-invariant.
    position = ray.at(hit.t)
    normal = affine_apply_dir(tf, n_obj).normalize(eps=1e-20)
    normal = vwhere(hit.front, normal, -normal)
    out_dir = -ray.d

    albedo = Vec3(scene.mat_albedo[mat_id, 0], scene.mat_albedo[mat_id, 1],
                  scene.mat_albedo[mat_id, 2])
    if scene.has_textures:
        tex_idx = scene.mat_tex[mat_id]
        albedo = albedo * sample_texture_array(scene.textures, tex_idx,
                                               uv_u, uv_v)

    energy = jnp.maximum(0.0, scene.mat_emission_energy[mat_id])
    emission = Vec3(scene.mat_emission[mat_id, 0] * energy,
                    scene.mat_emission[mat_id, 1] * energy,
                    scene.mat_emission[mat_id, 2] * energy)

    metallic = scene.mat_metallic[mat_id]
    roughness = scene.mat_roughness[mat_id]
    if scene.has_mr_textures:
        mr_idx = scene.mat_mr_tex[mat_id]
        mr = sample_texture_array(scene.textures, mr_idx, uv_u, uv_v)
        roughness = jnp.where(mr_idx >= 0, roughness * mr.y, roughness)
        metallic = jnp.where(mr_idx >= 0, metallic * mr.z, metallic)
    fresnel_0 = Vec3.full(0.02, like=albedo) + \
        (albedo - Vec3.full(0.02, like=albedo)) * metallic  # main.glsl:217
    diffuse_albedo = albedo - albedo * metallic              # main.glsl:218
    roughness = jnp.maximum(MIN_ROUGHNESS, roughness)

    return ShadingInfo(
        position=position,
        normal=normal,
        out_dir=out_dir,
        lambert_out=normal.dot(out_dir),
        emission=emission,
        diffuse_albedo=diffuse_albedo,
        fresnel_0=fresnel_0,
        roughness=roughness,
        transmission=scene.mat_transmission[mat_id],
        ior=scene.mat_ior[mat_id],
        albedo=albedo,
    )
