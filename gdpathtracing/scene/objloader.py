"""Wavefront OBJ loader → list of Surfaces.

Replaces the reference's Godot-importer ingestion path (ArrayMesh surfaces
read at src/bvh/bvh.cpp:192-198): each ``usemtl`` group becomes one surface
in order of first appearance, so per-surface material overrides line up the
same way the demo scene's do (demo.tscn:78-83). Polygon faces are
fan-triangulated; missing normals are computed per face; missing UVs are 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from gdpathtracing.bvh.blas import Surface


def load_obj(path: str) -> List[Surface]:
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    # surface name -> list of triangle corner tuples (vi, ti, ni)
    surfaces: Dict[str, List[List[tuple]]] = {}
    order: List[str] = []
    current = None

    def corner(spec: str) -> tuple:
        parts = spec.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        return (vi, ti, ni)

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif tok[0] == "usemtl":
                current = tok[1]
                if current not in surfaces:
                    surfaces[current] = []
                    order.append(current)
            elif tok[0] == "f":
                if current is None:
                    current = "__default__"
                    surfaces[current] = []
                    order.append(current)
                corners = [corner(s) for s in tok[1:]]
                for k in range(1, len(corners) - 1):  # fan triangulation
                    surfaces[current].append(
                        [corners[0], corners[k], corners[k + 1]])

    pos = np.asarray(positions, dtype=np.float32)
    nrm = np.asarray(normals, dtype=np.float32) if normals else None
    uv = np.asarray(uvs, dtype=np.float32) if uvs else None

    def resolve(i: int, n: int) -> int:
        return (i - 1) if i > 0 else (n + i)

    out: List[Surface] = []
    for name in order:
        tris = surfaces[name]
        if not tris:
            continue
        f = len(tris)
        p = np.zeros((f, 3, 3), dtype=np.float32)
        n_arr = np.zeros((f, 3, 3), dtype=np.float32)
        t_arr = np.zeros((f, 3, 2), dtype=np.float32)
        has_n = True
        for fi, tri in enumerate(tris):
            for ci, (vi, ti, ni) in enumerate(tri):
                p[fi, ci] = pos[resolve(vi, len(pos))]
                if ni != 0 and nrm is not None:
                    n_arr[fi, ci] = nrm[resolve(ni, len(nrm))]
                else:
                    has_n = False
                if ti != 0 and uv is not None:
                    t_arr[fi, ci] = uv[resolve(ti, len(uv))]
        out.append(Surface(positions=p,
                           normals=n_arr if has_n else None,
                           uvs=t_arr))
    return out
