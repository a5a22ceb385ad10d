"""Emissive-triangle light sampling (NEE) — reference wishlist item
("Add NEE/Direct light sampling", README.md:36); no reference counterpart.

The light table is derived from the scene arrays inside the jitted step
(cheap: L is small), so it stays correct under dynamic instance updates.
Emitters are double-sided, matching the reference's emission pickup (which
adds s.emission regardless of facing, main.glsl:380).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdpathtracing.core.math3d import affine_apply_point
from gdpathtracing.core.vec import Vec3
from gdpathtracing.scene.scene import Scene

_EPS = 1e-8


class LightTable(NamedTuple):
    v0: Vec3          # (L,) world-space triangle vertices
    v1: Vec3
    v2: Vec3
    normal: Vec3      # (L,) unit geometric normal
    area: jnp.ndarray
    emission: Vec3    # (L,) radiance (rgb * energy)
    pick_prob: jnp.ndarray  # (L,)
    cdf: jnp.ndarray        # (L,)
    # Packed (L, 17) rows [v0(3), e1(3), e2(3), n(3), emission(3), area,
    # pick_prob] — sample_light fetches the picked emitter with ONE row
    # gather instead of 12 scalar gathers.
    rows: jnp.ndarray = None


def build_light_table(scene: Scene) -> "LightTable | None":
    """World-space emitter table, or None when the scene has no lights."""
    if scene.n_lights == 0:
        return None
    inst = scene.light_inst
    tri = scene.light_tri
    tf = scene.inst_transform[inst]             # (L, 3, 4)
    pos = scene.tri_pos[tri]                    # (L, 3, 3)

    def vert(k):
        return affine_apply_point(
            tf, Vec3(pos[:, k, 0], pos[:, k, 1], pos[:, k, 2]))

    v0, v1, v2 = vert(0), vert(1), vert(2)
    n = (v1 - v0).cross(v2 - v0)
    nl = n.length()
    area = 0.5 * nl
    normal = n * (1.0 / jnp.maximum(nl, _EPS))

    slot = jnp.minimum(scene.tri_slot[tri], scene.inst_materials.shape[1] - 1)
    mat = scene.inst_materials[inst, slot]
    energy = jnp.maximum(0.0, scene.mat_emission_energy[mat])
    emission = Vec3(scene.mat_emission[mat, 0] * energy,
                    scene.mat_emission[mat, 1] * energy,
                    scene.mat_emission[mat, 2] * energy)

    power = area * emission.luminance()
    total = jnp.maximum(jnp.sum(power), _EPS)
    pick = power / total
    cdf = jnp.cumsum(pick)
    e1, e2 = v1 - v0, v2 - v0
    rows = jnp.stack([
        v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
        normal.x, normal.y, normal.z,
        emission.x, emission.y, emission.z, area, pick], axis=1)
    return LightTable(v0, v1, v2, normal, area, emission, pick, cdf, rows)


class LightSample(NamedTuple):
    point: Vec3
    normal: Vec3
    emission: Vec3
    pdf_solid: jnp.ndarray  # per-ray solid-angle pdf of the sampled dir
    wi: Vec3                # unit direction shading point → light
    dist: jnp.ndarray


def sample_light(table: LightTable, position: Vec3, r_pick, r1, r2
                 ) -> LightSample:
    """Pick an emitter ∝ power, sample a uniform point on it, convert the
    area pdf to solid angle at `position`."""
    L = table.cdf.shape[0]
    if L <= 128:
        # One-hot fetch: for small emitter counts the CDF pick AND the
        # row fetch are one (N, L) comparison matrix and one matmul at
        # HIGHEST precision (never TF32) — no searchsorted scan, no row
        # gather. Bit-exact: exactly one row weight is 1.0 and the rest
        # contribute 0*finite = 0.
        # Row selected = clip(#(cdf < r), 0, L-1), identical to the
        # searchsorted('left') + clip below.
        c = (table.cdf[None, :] >= r_pick[:, None])  # non-decr. in j;
        # >= so a cdf[j] == r tie picks j, matching searchsorted('left')
        cf = c.astype(jnp.float32)
        if L > 1:
            oh = jnp.concatenate(
                [cf[:, :1], cf[:, 1:] - cf[:, :-1]], axis=1)
            # clamp: r beyond cdf[-2] lands on the last emitter even if
            # float roundoff leaves cdf[-1] < 1
            oh = oh.at[:, L - 1].set(1.0 - cf[:, L - 2])
        else:
            oh = jnp.ones_like(cf)
        r = jax.lax.dot_general(
            oh, table.rows, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)  # (N, 17)
    else:
        # Default searchsorted lowers to a binary-search scan of
        # dependent gathers; an all-compare reduction is one fused
        # elementwise pass when it fits.
        method = "compare_all" if L <= 4096 else "sort"
        l = jnp.searchsorted(table.cdf, r_pick, method=method)
        l = jnp.clip(l, 0, L - 1)
        r = table.rows[l]  # (N, 17) — ONE row gather for all emitter data
    v0 = Vec3(r[:, 0], r[:, 1], r[:, 2])
    e1 = Vec3(r[:, 3], r[:, 4], r[:, 5])
    e2 = Vec3(r[:, 6], r[:, 7], r[:, 8])
    normal = Vec3(r[:, 9], r[:, 10], r[:, 11])
    emission = Vec3(r[:, 12], r[:, 13], r[:, 14])
    area = r[:, 15]
    pick = r[:, 16]

    su = jnp.sqrt(r1)
    b1 = r2 * su                 # v1 weight (same mapping as before:
    b2 = su * (1.0 - r2)         # v0 gets 1-su, v2 gets su(1-r2))
    point = v0 + e1 * b1 + e2 * b2

    delta = point - position
    dist2 = jnp.maximum(delta.length_sq(), _EPS)
    dist = jnp.sqrt(dist2)
    wi = delta * (1.0 / dist)
    cos_l = jnp.abs(normal.dot(-wi))  # double-sided emitter
    pdf_solid = dist2 / jnp.maximum(cos_l * area, _EPS) * pick
    pdf_solid = jnp.where(cos_l > 1e-6, pdf_solid, jnp.inf)  # grazing → no light
    return LightSample(point, normal, emission, pdf_solid, wi, dist)


def light_pdf_of_hit(table: LightTable, scene: Scene, hit_inst, hit_tri,
                     ray_dir: Vec3, t) -> jnp.ndarray:
    """Solid-angle pdf that NEE would have assigned to the direction that
    just hit (inst, tri) — the light half of the MIS weight for
    BRDF-sampled emission pickup. 0 when the hit is not an emitter."""
    # match (inst, tri) against the (L,) table
    eq = (scene.light_inst[None, :] == hit_inst[:, None]) & \
        (scene.light_tri[None, :] == hit_tri[:, None])     # (N, L)
    return _light_pdf(table, jnp.any(eq, axis=1), jnp.argmax(eq, axis=1),
                      ray_dir, t)


def light_pdf_of_eidx(table: LightTable, scene: Scene, eidx, ray_dir: Vec3,
                      t) -> jnp.ndarray:
    """light_pdf_of_hit for backends that report the expanded-triangle
    index: the emitter comes from one ``scene.isect_light`` gather instead
    of an (N, L) match against the light table."""
    li = scene.isect_light[jnp.maximum(eidx, 0)]
    return _light_pdf(table, li >= 0, jnp.maximum(li, 0), ray_dir, t)


def _light_pdf(table: LightTable, is_light, l, ray_dir: Vec3, t):
    cos_l = jnp.abs(Vec3(table.normal.x[l], table.normal.y[l],
                         table.normal.z[l]).dot(-ray_dir))
    dist2 = jnp.maximum(t * t, _EPS)
    pdf = dist2 / jnp.maximum(cos_l * table.area[l], _EPS) * \
        table.pick_prob[l]
    return jnp.where(is_light & (cos_l > 1e-6), pdf, 0.0)
