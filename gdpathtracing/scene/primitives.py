"""Procedural mesh primitives for demos and tests.

Replaces the reference demo's imported assets (project/demo/geometry/*.obj,
Godot PlaneMesh) with generated equivalents: the Cornell 5-face open cube
with the same three surface groups as cornell.obj's usemtl split, a 2x2
plane (Godot PlaneMesh analog, demo.tscn:21), and a UV sphere standing in
for Suzanne as the instanced test mesh.

Winding convention: CCW as seen from the normal side (standard OBJ). The
integrator's front-face test is ``dot(geometric_normal, ray.d) < 0`` — the
reference tests ``> 0`` (main.glsl:255) because Godot's importer flips OBJ
winding to clockwise; with unflipped CCW data our test lands on the same
faces.
"""

from __future__ import annotations

from typing import List

import numpy as np

from gdpathtracing.bvh.blas import Surface


def _quads_to_surface(verts: np.ndarray, quads: List[List[int]],
                      normal: List[List[float]]) -> tuple[np.ndarray, np.ndarray]:
    pos, nrm = [], []
    for q, n in zip(quads, normal):
        v = verts[q]
        n = np.asarray(n, dtype=np.float32)
        for tri in ((0, 1, 2), (0, 2, 3)):  # fan triangulation
            t = v[list(tri)]
            geom = np.cross(t[1] - t[0], t[2] - t[0])
            if np.dot(geom, n) < 0:  # enforce winding to match the normal
                t = t[[0, 2, 1]]
            pos.append(t)
            nrm.append(np.tile(n, (3, 1)))
    return np.stack(pos), np.stack(nrm)


def cornell_box(size: float = 5.0) -> List[Surface]:
    """Open cube, interior-facing: 5 faces in 3 surfaces grouped exactly like
    the demo's cornell.obj usemtl groups — surface 0 = ceiling + left wall +
    floor, surface 1 = back wall, surface 2 = front wall."""
    s = size
    v = np.array([
        [s, s, -s], [s, -s, -s], [s, s, s], [s, -s, s],
        [-s, s, -s], [-s, -s, -s], [-s, s, s], [-s, -s, s],
    ], dtype=np.float32)
    # Quads by vertex index, with inward normals; CCW from the normal side.
    surf0_p, surf0_n = _quads_to_surface(
        v,
        [[0, 4, 6, 2],    # ceiling y=+s, normal -y
         [7, 6, 4, 5],    # wall x=-s, normal +x
         [5, 1, 3, 7]],   # floor y=-s, normal +y
        [[0, -1, 0], [1, 0, 0], [0, 1, 0]],
    )
    surf1_p, surf1_n = _quads_to_surface(
        v, [[5, 4, 0, 1]], [[0, 0, 1]])    # back wall z=-s, normal +z
    surf2_p, surf2_n = _quads_to_surface(
        v, [[3, 2, 6, 7]], [[0, 0, -1]])   # front wall z=+s, normal -z
    return [Surface(surf0_p, surf0_n),
            Surface(surf1_p, surf1_n),
            Surface(surf2_p, surf2_n)]


def plane_mesh(size: float = 2.0) -> List[Surface]:
    """Godot PlaneMesh analog: size x size facing +Y, 2 triangles, UVs in
    [0,1]."""
    h = size * 0.5
    verts = np.array([[-h, 0, -h], [-h, 0, h], [h, 0, h], [h, 0, -h]],
                     dtype=np.float32)
    uv = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dtype=np.float32)
    pos = np.stack([verts[[0, 1, 2]], verts[[0, 2, 3]]])
    uvs = np.stack([uv[[0, 1, 2]], uv[[0, 2, 3]]])
    nrm = np.tile(np.array([0, 1, 0], dtype=np.float32), (2, 3, 1))
    return [Surface(pos, nrm, uvs)]


def uv_sphere(radius: float = 1.0, rings: int = 16,
              segments: int = 32) -> List[Surface]:
    """UV sphere with smooth outward normals and spherical UVs."""
    pos, nrm, uvs = [], [], []

    def point(r_i: int, s_i: int):
        theta = np.pi * r_i / rings
        phi = 2 * np.pi * s_i / segments
        n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                      np.sin(theta) * np.sin(phi)], dtype=np.float32)
        return radius * n, n, np.array([s_i / segments, r_i / rings],
                                       dtype=np.float32)

    for r_i in range(rings):
        for s_i in range(segments):
            p00 = point(r_i, s_i)
            p01 = point(r_i, s_i + 1)
            p10 = point(r_i + 1, s_i)
            p11 = point(r_i + 1, s_i + 1)
            tris = []
            if r_i > 0:
                tris.append((p00, p10, p01))
            if r_i < rings - 1:
                tris.append((p01, p10, p11))
            for tri in tris:
                p = np.stack([t[0] for t in tri])
                n = np.stack([t[1] for t in tri])
                u = np.stack([t[2] for t in tri])
                geom = np.cross(p[1] - p[0], p[2] - p[0])
                if np.dot(geom, n.mean(axis=0)) < 0:  # enforce outward winding
                    p, n, u = p[[0, 2, 1]], n[[0, 2, 1]], u[[0, 2, 1]]
                pos.append(p)
                nrm.append(n)
                uvs.append(u)
    return [Surface(np.stack(pos), np.stack(nrm), np.stack(uvs))]


def quad_ccw(v0, v1, v2, v3) -> Surface:
    """Single quad surface from 4 corners (CCW), face normal computed."""
    v = np.asarray([v0, v1, v2, v3], dtype=np.float32)
    pos = np.stack([v[[0, 1, 2]], v[[0, 2, 3]]])
    return Surface(pos)
