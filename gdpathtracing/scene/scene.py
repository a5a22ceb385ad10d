"""Scene: the flat device-array pytree + its builder ("scene compiler").

Analog of the reference's GeometryGroup3D::build()
(src/path_tracing/geometry_group3d.cpp:228-366), which scrapes the Godot
scene tree into 7 flat GPU buffers. Here the same compilation — mesh dedupe,
material resolution/dedupe, texture-array assembly, per-mesh BLAS build,
per-instance records, TLAS build, geometry/shading data split — produces a
registered JAX pytree of jnp arrays that passes straight into jitted render
steps and shards trivially (scene is replicated; rays are sharded).

Improvements over the reference, not copied from it:
- material tables per instance are N-wide, not capped at 3 (bvh.h:75);
- instance world AABBs use the correct corner transform (bvh.h:110 quirk).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from gdpathtracing.bvh.blas import BLASBuilder, Surface
from gdpathtracing.bvh.tlas import build_tlas, instance_world_aabb
from gdpathtracing.scene.materials import (DEFAULT_MATERIAL, Material,
                                               resize_texture)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Flat scene arrays. Counts live in the shapes (static under jit).

    Triangles (in BVH order; the hot/cold split of
    geometry_group3d.cpp:356-365 = tri_pos vs the rest):
      tri_pos (T, 3, 3) f32 — [tri, vertex, xyz]
      tri_normal (T, 3, 3) f32
      tri_uv (T, 3, 2) f32
      tri_slot (T,) i32 — surface slot into the instance material table
    BLAS nodes (leaf ⇔ count > 0; bvh.h:46-54):
      node_min/node_max (B, 3) f32; node_left/right/first/count (B,) i32
    TLAS nodes (leaf ⇔ left == 0; bvh.h:56-62):
      tlas_min/tlas_max (L, 3) f32; tlas_left/right/inst (L,) i32
    Instances (bvh.h:64-79):
      inst_transform / inst_inv_transform (I, 3, 4) f32 — affine rows
      inst_root (I,) i32 — BLAS subtree root node
      inst_materials (I, S) i32 — per-surface material ids
    Materials (render_parameters.h:49-57):
      mat_albedo (M, 3), mat_emission (M, 3), mat_emission_energy (M,),
      mat_metallic (M,), mat_roughness (M,) f32, mat_tex (M,) i32 (-1 = none)
    Textures: textures (X, R, R, 3) f32 (dummy 1-slice when none —
      geometry_group3d.cpp:301-303)
    """

    tri_pos: jnp.ndarray
    tri_normal: jnp.ndarray
    tri_uv: jnp.ndarray
    tri_slot: jnp.ndarray
    # Per-triangle edge OPENNESS (T, 3) f32 {0, 1}, ordered to match the
    # unit-space barycentric margins: col 0 ↔ u = 0 (edge v0-v2), col 1 ↔
    # v = 0 (v0-v1), col 2 ↔ 1-u-v = 0 (v1-v2). An edge is open (1) when
    # no other triangle of the same mesh shares its vertex positions.
    # The soft-visibility estimators (occlusion_soft, soft_primary)
    # soften ONLY open edges: interior seams (e.g. a quad's
    # diagonal) stay hard, so they neither leak light through blockers nor
    # blend silhouettes mid-surface. Transform-invariant (object-space
    # topology), so dynamic instance updates need no rebuild.
    tri_edge_open: jnp.ndarray
    node_min: jnp.ndarray
    node_max: jnp.ndarray
    node_left: jnp.ndarray
    node_right: jnp.ndarray
    node_first: jnp.ndarray
    node_count: jnp.ndarray
    tlas_min: jnp.ndarray
    tlas_max: jnp.ndarray
    tlas_left: jnp.ndarray
    tlas_right: jnp.ndarray
    tlas_inst: jnp.ndarray
    inst_transform: jnp.ndarray
    inst_inv_transform: jnp.ndarray
    inst_root: jnp.ndarray
    inst_materials: jnp.ndarray
    mat_albedo: jnp.ndarray
    mat_emission: jnp.ndarray
    mat_emission_energy: jnp.ndarray
    mat_metallic: jnp.ndarray
    mat_roughness: jnp.ndarray
    mat_transmission: jnp.ndarray
    mat_ior: jnp.ndarray
    mat_tex: jnp.ndarray
    mat_mr_tex: jnp.ndarray  # metallic-roughness texture index (-1 = none)
    textures: jnp.ndarray
    # Unit-triangle-space intersection arrays over the instance-EXPANDED
    # world-space triangle list (E = Σ instance tri counts). Each expanded
    # triangle e carries an affine map world→(u, v, w) with w=0 on the
    # triangle plane; a ray hit reduces to two (N,4)x(4,E) matmuls + an
    # elementwise epilogue — the dense intersection path of trace_unit and
    # the Pallas kernel (no reference counterpart; SURVEY.md §7 step 4).
    # isect_mu/mv/mw: (4, E) f32 — columns [r_x, r_y, r_z, c] so that
    #   u_o = (o,1)·col, u_d = (d,0)·col, etc.
    isect_mu: jnp.ndarray
    isect_mv: jnp.ndarray
    isect_mw: jnp.ndarray
    isect_inst: jnp.ndarray  # (E,) i32 instance of expanded triangle
    isect_tri: jnp.ndarray   # (E,) i32 global-pool triangle index
    # Expanded triangles are Morton-sorted; per 256-triangle chunk AABBs
    # ((8, C): rows 0-2 min, 3-5 max, 6-7 padding) let the Pallas kernel
    # skip whole (ray-block × chunk) tiles — a "chunked LBVH" of depth 1.
    isect_chunk_bounds: jnp.ndarray
    # Row-major copy of the unit-space columns ((E, 12):
    # [mu(4), mv(4), mw(4)]) for per-winner epilogue recompute — a
    # contiguous row gather instead of strided column gathers.
    isect_cols: jnp.ndarray
    # Packed per-expanded-triangle shading rows (E, 16) f32:
    # [n0.xyz, n1.xyz, n2.xyz (world space), uv0, uv1, uv2, mat_id] — the
    # whole shading fetch becomes ONE contiguous-row gather instead of ~12
    # (see render/shading.py fast path).
    isect_shade: jnp.ndarray
    # Per-expanded-triangle light-table index (E,) i32 (-1 = not an
    # emitter, incl. padding) — lets the NEE MIS pickup pdf be a single
    # packed-row gather instead of an (N, L) comparison matrix
    # (render/lights.py).
    isect_light: jnp.ndarray
    # Emissive (instance, triangle) pairs for NEE (render/lights.py);
    # length max(L, 1) — n_lights is the true count.
    light_inst: jnp.ndarray
    light_tri: jnp.ndarray
    # Optional equirect HDRI environment ((He, We, 3) f32 linear; dummy
    # (1,1,3) + has_env=False → the analytic gradient sky is used).
    env_map: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((1, 1, 3), jnp.float32))
    env_energy: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(1.0))
    # Static per-instance triangle ranges (tuples → hashable jit statics);
    # used by the brute-force oracle backend.
    inst_tri_first: tuple = dataclasses.field(
        metadata=dict(static=True), default=())
    inst_tri_count: tuple = dataclasses.field(
        metadata=dict(static=True), default=())
    # Static TLAS refit schedule: internal node ids in children-first
    # order (scene/dynamic.py refits AABBs on device with it).
    tlas_refit_order: tuple = dataclasses.field(
        metadata=dict(static=True), default=())
    n_lights: int = dataclasses.field(metadata=dict(static=True), default=0)
    has_env: bool = dataclasses.field(metadata=dict(static=True),
                                      default=False)
    has_transmission: bool = dataclasses.field(metadata=dict(static=True),
                                               default=False)
    # Static texture presence flags: when False the shading path skips the
    # bilinear texture gathers entirely (sampling a dummy 1-slice array
    # would waste ~8 gathers per bounce).
    has_textures: bool = dataclasses.field(metadata=dict(static=True),
                                           default=False)
    has_mr_textures: bool = dataclasses.field(metadata=dict(static=True),
                                              default=False)

    @property
    def n_tris(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def n_instances(self) -> int:
        return self.inst_transform.shape[0]

    @property
    def n_materials(self) -> int:
        return self.mat_albedo.shape[0]

    def device_put(self, sharding=None) -> "Scene":
        if sharding is None:
            return jax.device_put(self)
        return jax.device_put(self, sharding)


@dataclasses.dataclass
class _Instance:
    mesh_id: int
    transform: np.ndarray  # (3, 4)
    material_ids: List[int]


ISECT_CHUNK = 256  # culling unit of ops/intersect_pallas.py (CHUNK)


def _morton3(x: np.ndarray) -> np.ndarray:
    """(n, 3) uint in [0, 1024) → interleaved 30-bit Morton codes."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << np.uint64(1))
            | (spread(x[:, 2]) << np.uint64(2)))


def build_shade_rows(tri_normal, tri_uv, tri_slot, inst_materials,
                     inst_transform, isect_inst, isect_tri):
    """(E, 16) packed shading rows (works for np or jnp inputs — used at
    build time and by scene.dynamic updates)."""
    xp = jnp if isinstance(tri_normal, jnp.ndarray) else np
    tf = inst_transform[isect_inst]          # (E, 3, 4)
    nrm = tri_normal[isect_tri]              # (E, 3, 3) object space
    world_n = xp.einsum("eab,evb->eva", tf[:, :, :3], nrm)
    uv = tri_uv[isect_tri]                   # (E, 3, 2)
    slot = xp.minimum(tri_slot[isect_tri], inst_materials.shape[1] - 1)
    mat = inst_materials[isect_inst, slot]
    e = world_n.shape[0]
    return xp.concatenate([
        world_n.reshape(e, 9),
        uv.reshape(e, 6),
        mat.reshape(e, 1).astype(xp.float32),
    ], axis=1).astype(xp.float32)


def _edge_openness(pos: np.ndarray) -> np.ndarray:
    """(c, 3, 3) object-space triangle positions of ONE mesh → (c, 3) f32
    openness flags per barycentric edge (Scene.tri_edge_open layout).
    Vertices are merged with a TRUE tolerance (~1e-5): eight offset
    quantization grids + union-find, so coincident vertices straddling a
    single grid's rounding boundary still merge (a single-grid round
    falsely marked such seams open, softening interior edges in the
    soft-shadow estimators). Any two vertices within eps/2 (inf-norm)
    share a cell in at least one of the 2^3 half-cell-offset grids."""
    c = pos.shape[0]
    if c == 0:
        return np.zeros((0, 3), np.float32)
    eps = 1e-5
    flat = np.ascontiguousarray(pos, dtype=np.float64).reshape(-1, 3)
    nv = flat.shape[0]
    grps = []
    for ox in (0.0, 0.5):
        for oy in (0.0, 0.5):
            for oz in (0.0, 0.5):
                q = np.floor(flat / eps + np.array([ox, oy, oz]))
                _, grp = np.unique(
                    np.ascontiguousarray(q).view([("", np.float64)] * 3),
                    return_inverse=True)
                grps.append(grp.ravel())
    # Connected components across the eight groupings via min-label
    # propagation (vectorized; converges in a few sweeps — merge chains
    # across offset grids are short).
    labels = np.arange(nv, dtype=np.int64)
    for _ in range(32):
        prev = labels
        for grp in grps:
            gmin = np.full(grp.max() + 1, nv, dtype=np.int64)
            np.minimum.at(gmin, grp, labels)
            labels = gmin[grp]
        if np.array_equal(labels, prev):
            break
    _, vid = np.unique(labels, return_inverse=True)
    vid = vid.reshape(c, 3).astype(np.int64)
    # Edge per margin: u=0 ↔ (v0, v2); v=0 ↔ (v0, v1); w=0 ↔ (v1, v2).
    e_u = np.sort(vid[:, [0, 2]], axis=1)
    e_v = np.sort(vid[:, [0, 1]], axis=1)
    e_w = np.sort(vid[:, [1, 2]], axis=1)
    alle = np.concatenate([e_u, e_v, e_w], axis=0)      # (3c, 2)
    keys = alle[:, 0] * (vid.max() + 1) + alle[:, 1]
    _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    return (cnt[inv] < 2).astype(np.float32).reshape(3, c).T


def _build_isect_arrays(tri_pos: np.ndarray, inst_transform: np.ndarray,
                        inst_ranges: dict, pad_to: int = ISECT_CHUNK):
    """Expand instances into world space and build per-triangle affine
    world→(u, v, w) maps (Woop-style unit-triangle space).

    For triangle (w0, e1, e2) with n = e1×e2: M = [e1 e2 n] (columns),
    p = w0 + M·(u, v, w) ⇒ (u, v, w) = M⁻¹(p - w0). A ray (o, d) then hits
    at t = -w_o/w_d with barycentrics (u_o + t·u_d, v_o + t·v_d).
    Degenerate triangles get zero columns (⇒ w_d = 0 ⇒ rejected).

    E is padded to a multiple of `pad_to` with zero columns so kernels can
    assume whole chunks; padding maps to inst/tri index 0 but can never
    report a hit.
    """
    mats, insts, tris = [], [], []
    worlds = []
    for inst, (first, count) in sorted(inst_ranges.items()):
        tf = inst_transform[inst]
        pos = tri_pos[first:first + count]  # (c, 3, 3) object space
        world = pos @ tf[:, :3].T + tf[:, 3]
        worlds.append(world)
        w0 = world[:, 0]
        e1 = world[:, 1] - w0
        e2 = world[:, 2] - w0
        n = np.cross(e1, e2)
        m = np.stack([e1, e2, n], axis=-1)  # (c, 3, 3) columns
        det = np.linalg.det(m)
        ok = np.abs(det) > 1e-18
        m_safe = np.where(ok[:, None, None], m, np.eye(3, dtype=np.float32))
        minv = np.linalg.inv(m_safe).astype(np.float32)
        minv = np.where(ok[:, None, None], minv, 0.0).astype(np.float32)
        c = -np.einsum("cij,cj->ci", minv, w0).astype(np.float32)
        cols = np.concatenate([minv, c[:, :, None]], axis=2)  # (c, 3, 4)
        mats.append(cols)
        insts.append(np.full(count, inst, dtype=np.int32))
        tris.append(np.arange(first, first + count, dtype=np.int32))
    cols = np.concatenate(mats, axis=0)  # (E, 3, 4)
    inst_ids = np.concatenate(insts)
    tri_ids = np.concatenate(tris)
    world = np.concatenate(worlds, axis=0)  # (E, 3, 3)

    # Morton-sort by world centroid: spatially-coherent chunks → tight
    # chunk AABBs → effective per-chunk culling in the kernel.
    cent = world.mean(axis=1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")
    cols, inst_ids, tri_ids = cols[order], inst_ids[order], tri_ids[order]
    world = world[order]

    e = len(cols)
    e_pad = -(-e // pad_to) * pad_to
    if e_pad != e:
        cols = np.concatenate(
            [cols, np.zeros((e_pad - e, 3, 4), np.float32)], axis=0)
        inst_ids = np.concatenate(
            [inst_ids, np.zeros(e_pad - e, np.int32)])
        tri_ids = np.concatenate([tri_ids, np.zeros(e_pad - e, np.int32)])
        # Padding gets point-degenerate bounds inside the last real chunk
        # so it never widens a chunk AABB.
        pad_pt = world[-1, :1]
        world = np.concatenate(
            [world, np.tile(pad_pt[None], (e_pad - e, 3, 1))], axis=0)

    n_chunks = e_pad // pad_to
    wc = world.reshape(n_chunks, pad_to, 3, 3)
    chunk_min = wc.reshape(n_chunks, -1, 3).min(axis=1)
    chunk_max = wc.reshape(n_chunks, -1, 3).max(axis=1)
    chunk_bounds = np.zeros((8, n_chunks), np.float32)
    chunk_bounds[0:3] = chunk_min.T
    chunk_bounds[3:6] = chunk_max.T

    # (4, E) per component: columns [r_x, r_y, r_z, c]
    mu = cols[:, 0, :].T.astype(np.float32).copy()
    mv = cols[:, 1, :].T.astype(np.float32).copy()
    mw = cols[:, 2, :].T.astype(np.float32).copy()
    return mu, mv, mw, inst_ids, tri_ids, chunk_bounds


class SceneBuilder:
    """Programmatic scene assembly → :class:`Scene`.

    Replaces the reference's Godot scene scrape
    (collect_mesh_instances, geometry_group3d.cpp:150-214): meshes are added
    once and instanced many times (the dedupe-by-pointer of cpp:172-185
    becomes an explicit mesh handle); per-surface material overrides resolve
    exactly as the reference does (override or default slot 0).
    """

    def __init__(self, default_material: Material = DEFAULT_MATERIAL,
                 texture_resolution: int = 512):
        # Material slot 0 = default (geometry_group3d.cpp:239-247).
        self.texture_resolution = texture_resolution
        self._materials: List[Material] = [default_material]
        self._material_keys = {default_material.key(): 0}
        self._meshes: List[List[Surface]] = []
        self._instances: List[_Instance] = []
        self._env: "np.ndarray | None" = None
        self._env_energy = 1.0

    def set_environment(self, image: np.ndarray,
                        energy: float = 1.0) -> None:
        """Equirect HDRI sky ((H, W, 3) float linear or uint8). Replaces
        the analytic gradient sky for miss rays."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        self._env = img.astype(np.float32)
        self._env_energy = float(energy)

    # ---- meshes ----
    def add_mesh(self, surfaces: Sequence[Surface]) -> int:
        """Register a unique mesh (list of surfaces); returns a mesh id."""
        self._meshes.append(list(surfaces))
        return len(self._meshes) - 1

    # ---- materials ----
    def material_id(self, mat: Material | None) -> int:
        """Dedupe + register a material; None → default slot 0
        (geometry_group3d.cpp:186-202)."""
        if mat is None:
            return 0
        k = mat.key()
        if k not in self._material_keys:
            self._material_keys[k] = len(self._materials)
            self._materials.append(mat)
        return self._material_keys[k]

    # ---- instances ----
    def add_instance(self, mesh_id: int, transform,
                     materials: "Sequence[Material | None] | Material | None" = None,
                     material_override: Material | None = None) -> int:
        """Instance a mesh. `materials` = per-surface overrides;
        `material_override` wins over all surfaces (the Godot
        material_override precedence, geometry_group3d.cpp:186-202)."""
        transform = np.asarray(transform, dtype=np.float32)
        if transform.shape == (4, 4):
            transform = transform[:3, :]
        assert transform.shape == (3, 4), transform.shape
        n_surf = len(self._meshes[mesh_id])
        if material_override is not None:
            ids = [self.material_id(material_override)] * n_surf
        else:
            if materials is None:
                mats: List[Material | None] = [None] * n_surf
            elif isinstance(materials, Material):
                mats = [materials] * n_surf
            else:
                mats = list(materials) + [None] * (n_surf - len(materials))
            ids = [self.material_id(m) for m in mats[:n_surf]]
        self._instances.append(_Instance(mesh_id, transform, ids))
        return len(self._instances) - 1

    # ---- build ----
    def build(self) -> Scene:
        if not self._instances:
            raise ValueError("scene has no instances")

        # BLAS per unique mesh into shared pools
        # (geometry_group3d.cpp:306-313).
        blas_builder = BLASBuilder()
        used_meshes = sorted({i.mesh_id for i in self._instances})
        mesh_to_root = {}
        for mid in used_meshes:
            mesh_to_root[mid] = blas_builder.build_mesh(self._meshes[mid])
        blas = blas_builder.finalize()
        root_aabb = {mid: blas_builder.mesh_root_aabbs[k]
                     for k, mid in enumerate(used_meshes)}
        tri_range = {mid: blas_builder.mesh_tri_ranges[k]
                     for k, mid in enumerate(used_meshes)}

        # Instances + world AABBs + TLAS.
        n_inst = len(self._instances)
        max_surf = max(len(i.material_ids) for i in self._instances)
        inst_transform = np.zeros((n_inst, 3, 4), dtype=np.float32)
        inst_inv = np.zeros((n_inst, 3, 4), dtype=np.float32)
        inst_root = np.zeros(n_inst, dtype=np.int32)
        inst_materials = np.zeros((n_inst, max_surf), dtype=np.int32)
        mins, maxs = [], []
        for k, inst in enumerate(self._instances):
            inst_transform[k] = inst.transform
            r_inv = np.linalg.inv(inst.transform[:, :3])
            inst_inv[k, :, :3] = r_inv
            inst_inv[k, :, 3] = -r_inv @ inst.transform[:, 3]
            inst_root[k] = mesh_to_root[inst.mesh_id]
            inst_materials[k, :len(inst.material_ids)] = inst.material_ids
            bmin, bmax = root_aabb[inst.mesh_id]
            wmin, wmax = instance_world_aabb(inst.transform, bmin, bmax)
            mins.append(wmin)
            maxs.append(wmax)
        tlas = build_tlas(mins, maxs)

        # Material arrays + texture array
        # (geometry_group3d.cpp:271-303).
        n_mat = len(self._materials)
        mat_albedo = np.zeros((n_mat, 3), dtype=np.float32)
        mat_emission = np.zeros((n_mat, 3), dtype=np.float32)
        mat_energy = np.zeros(n_mat, dtype=np.float32)
        mat_metal = np.zeros(n_mat, dtype=np.float32)
        mat_rough = np.zeros(n_mat, dtype=np.float32)
        mat_trans = np.zeros(n_mat, dtype=np.float32)
        mat_ior = np.full(n_mat, 1.5, dtype=np.float32)
        mat_tex = np.full(n_mat, -1, dtype=np.int32)
        mat_mr_tex = np.full(n_mat, -1, dtype=np.int32)
        tex_by_id: dict[int, int] = {}
        textures: List[np.ndarray] = []

        def register(img):
            key = id(img)
            if key not in tex_by_id:
                tex_by_id[key] = len(textures)
                textures.append(resize_texture(img, self.texture_resolution))
            return tex_by_id[key]

        for i, m in enumerate(self._materials):
            mat_albedo[i] = m.albedo
            mat_emission[i] = m.emission
            mat_energy[i] = m.emission_energy
            mat_metal[i] = m.metallic
            mat_rough[i] = m.roughness
            mat_trans[i] = m.transmission
            mat_ior[i] = m.ior
            if m.albedo_texture is not None:
                mat_tex[i] = register(m.albedo_texture)
            if m.metallic_roughness_texture is not None:
                mat_mr_tex[i] = register(m.metallic_roughness_texture)
        if not textures:  # dummy slice (geometry_group3d.cpp:301-303)
            textures = [np.ones((1, 1, 3), dtype=np.float32)]
        tex_array = np.stack(textures, axis=0)

        # Instance-expanded unit-triangle-space intersection matrices.
        (isect_mu, isect_mv, isect_mw, isect_inst, isect_tri,
         isect_chunk_bounds) = _build_isect_arrays(
            blas.tri_pos, inst_transform,
            {k: tri_range[i.mesh_id] for k, i in enumerate(self._instances)})

        isect_shade = build_shade_rows(
            blas.tri_normal, blas.tri_uv, blas.tri_slot, inst_materials,
            inst_transform, isect_inst, isect_tri)

        # Emissive (instance, triangle) pairs → NEE light table.
        light_inst, light_tri = [], []
        for k, inst in enumerate(self._instances):
            first, count = tri_range[inst.mesh_id]
            slots = np.minimum(blas.tri_slot[first:first + count],
                               max_surf - 1)
            mats = inst_materials[k, slots]
            emissive = (mat_energy[mats] > 0.0) & \
                (np.abs(mat_emission[mats]).sum(axis=1) > 0.0)
            idx = np.nonzero(emissive)[0]
            light_inst.append(np.full(len(idx), k, np.int32))
            light_tri.append((first + idx).astype(np.int32))
        light_inst = np.concatenate(light_inst) if light_inst else \
            np.zeros(0, np.int32)
        light_tri = np.concatenate(light_tri) if light_tri else \
            np.zeros(0, np.int32)
        n_lights = len(light_inst)
        if n_lights == 0:
            light_inst = np.zeros(1, np.int32)
            light_tri = np.zeros(1, np.int32)

        # Per-expanded-triangle light index: (inst, tri) → position in the
        # light table, -1 otherwise. Padding/degenerate rows (zero unit-
        # space columns) are excluded — they alias (inst 0, tri 0).
        t_count = blas.tri_pos.shape[0]
        e_pad = isect_mu.shape[1]
        if n_lights > 0:
            lkey = light_inst.astype(np.int64) * t_count + light_tri
            lorder = np.argsort(lkey, kind="stable")
            lsorted = lkey[lorder]
            ekey = isect_inst.astype(np.int64) * t_count + isect_tri
            pos = np.clip(np.searchsorted(lsorted, ekey), 0,
                          len(lsorted) - 1)
            nonpad = np.abs(isect_mw).sum(axis=0) > 0
            isect_light = np.where((lsorted[pos] == ekey) & nonpad,
                                   lorder[pos], -1).astype(np.int32)
        else:
            isect_light = np.full(e_pad, -1, np.int32)

        tri_edge_open = np.ones((blas.tri_pos.shape[0], 3), np.float32)
        for mid in used_meshes:
            first, count = tri_range[mid]
            tri_edge_open[first:first + count] = _edge_openness(
                blas.tri_pos[first:first + count])

        return Scene(
            tri_pos=jnp.asarray(blas.tri_pos),
            tri_normal=jnp.asarray(blas.tri_normal),
            tri_uv=jnp.asarray(blas.tri_uv),
            tri_slot=jnp.asarray(blas.tri_slot),
            tri_edge_open=jnp.asarray(tri_edge_open),
            node_min=jnp.asarray(blas.node_min),
            node_max=jnp.asarray(blas.node_max),
            node_left=jnp.asarray(blas.node_left),
            node_right=jnp.asarray(blas.node_right),
            node_first=jnp.asarray(blas.node_first),
            node_count=jnp.asarray(blas.node_count),
            tlas_min=jnp.asarray(tlas.node_min),
            tlas_max=jnp.asarray(tlas.node_max),
            tlas_left=jnp.asarray(tlas.node_left),
            tlas_right=jnp.asarray(tlas.node_right),
            tlas_inst=jnp.asarray(tlas.node_inst),
            inst_transform=jnp.asarray(inst_transform),
            inst_inv_transform=jnp.asarray(inst_inv),
            inst_root=jnp.asarray(inst_root),
            inst_materials=jnp.asarray(inst_materials),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_emission=jnp.asarray(mat_emission),
            mat_emission_energy=jnp.asarray(mat_energy),
            mat_metallic=jnp.asarray(mat_metal),
            mat_roughness=jnp.asarray(mat_rough),
            mat_transmission=jnp.asarray(mat_trans),
            mat_ior=jnp.asarray(mat_ior),
            mat_tex=jnp.asarray(mat_tex),
            mat_mr_tex=jnp.asarray(mat_mr_tex),
            textures=jnp.asarray(tex_array),
            isect_mu=jnp.asarray(isect_mu),
            isect_mv=jnp.asarray(isect_mv),
            isect_mw=jnp.asarray(isect_mw),
            isect_inst=jnp.asarray(isect_inst),
            isect_tri=jnp.asarray(isect_tri),
            isect_chunk_bounds=jnp.asarray(isect_chunk_bounds),
            isect_cols=jnp.concatenate(
                [jnp.asarray(isect_mu).T, jnp.asarray(isect_mv).T,
                 jnp.asarray(isect_mw).T], axis=1),
            isect_shade=jnp.asarray(isect_shade),
            isect_light=jnp.asarray(isect_light),
            light_inst=jnp.asarray(light_inst),
            light_tri=jnp.asarray(light_tri),
            n_lights=n_lights,
            env_map=jnp.asarray(self._env) if self._env is not None
            else jnp.zeros((1, 1, 3), jnp.float32),
            env_energy=jnp.float32(self._env_energy),
            has_env=self._env is not None,
            has_transmission=bool((mat_trans > 0).any()),
            has_textures=bool((mat_tex >= 0).any()),
            has_mr_textures=bool((mat_mr_tex >= 0).any()),
            inst_tri_first=tuple(int(tri_range[i.mesh_id][0])
                                 for i in self._instances),
            inst_tri_count=tuple(int(tri_range[i.mesh_id][1])
                                 for i in self._instances),
            tlas_refit_order=_tlas_postorder(tlas),
        )


def _tlas_postorder(tlas) -> tuple:
    """Children-first order of internal TLAS nodes (slot-0 root copy
    last), for device-side AABB refit."""
    order = []

    def walk(i: int):
        if tlas.node_left[i] == 0:
            return
        walk(int(tlas.node_left[i]))
        walk(int(tlas.node_right[i]))
        order.append(i)

    # Node 0 duplicates the true root; find it via node 0's children.
    if tlas.node_left[0] != 0:
        walk(int(tlas.node_left[0]))
        walk(int(tlas.node_right[0]))
        order.append(0)
    return tuple(order)
