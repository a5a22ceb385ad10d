"""Binned-SAH BLAS (bottom-level BVH) builder over triangle meshes.

Host-side NumPy implementation of the same algorithm family as the
reference's C++ builder (src/bvh/bvh.cpp:24-262): top-down recursion,
8-bin SAH sweep over the three axes, in-place partition by centroid with a
median-split fallback, leaves of at most ``MAX_LEAF_TRIS`` triangles, and a
shared node/triangle pool across meshes (each build returns its subtree root
index — bvh.cpp:187-223).

Deliberate deviations from the reference (quirks fixed, not copied —
SURVEY.md §7 end):

- AABBs initialize max with ``-inf``; the reference used
  ``numeric_limits<float>::min()`` which breaks all-negative geometry
  (bvh.cpp:6-10).
- When the SAH says "don't split" but the node holds more than
  ``MAX_LEAF_TRIS`` triangles, we median-split anyway. The reference allows
  arbitrarily large leaves (bvh.cpp:146-150); a hard bound lets the wavefront
  traversal unroll leaf intersection into a fixed 4-wide masked test.

The emitted arrays mirror the reference's GPU-struct split
(geometry_group3d.cpp:356-365): traversal-hot node fields and triangle
geometry separate from cold shading data.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

BINS = 8              # bvh.cpp EvaluateSAH bin count
MAX_LEAF_TRIS = 4     # bvh.cpp:125
SAH_SLACK = 0.8       # bvh.cpp:146-150 — accept slightly worse splits


@dataclasses.dataclass
class Surface:
    """One mesh surface: triangle soup with a per-surface material slot.

    ``positions``/``normals``: (F, 3, 3) float32, ``uvs``: (F, 3, 2) float32.
    The surface index within its mesh becomes the triangle's
    ``material_slot`` (bvh.cpp:209).
    """

    positions: np.ndarray
    normals: np.ndarray | None = None
    uvs: np.ndarray | None = None

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float32)
        assert self.positions.ndim == 3 and self.positions.shape[1:] == (3, 3)
        if self.normals is None:
            e1 = self.positions[:, 1] - self.positions[:, 0]
            e2 = self.positions[:, 2] - self.positions[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            self.normals = np.repeat(n[:, None, :], 3, axis=1)
        self.normals = np.asarray(self.normals, dtype=np.float32)
        if self.uvs is None:
            self.uvs = np.zeros((len(self.positions), 3, 2), dtype=np.float32)
        self.uvs = np.asarray(self.uvs, dtype=np.float32)

    @property
    def n_tris(self) -> int:
        return len(self.positions)


@dataclasses.dataclass
class BLASArrays:
    """Flat SoA output of the builder — shared pools across all meshes.

    Nodes (analog of BVHNode, bvh.h:46-54; leaf ⇔ count > 0):
      ``node_min``/``node_max`` (B, 3) f32, ``node_left``/``node_right``/
      ``node_first``/``node_count`` (B,) int32.
    Triangles, permuted into BVH order:
      ``tri_pos`` (T, 3, 3), ``tri_normal`` (T, 3, 3), ``tri_uv`` (T, 3, 2),
      ``tri_slot`` (T,) int32 material slot.
    """

    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    tri_pos: np.ndarray
    tri_normal: np.ndarray
    tri_uv: np.ndarray
    tri_slot: np.ndarray


class BLASBuilder:
    """Shared-pool builder. One ``build_mesh`` call per unique mesh
    (geometry_group3d.cpp:306-313); ``finalize`` emits the flat arrays.

    ``backend``: 'auto' uses the native C++ core (native/bvh_builder.cpp,
    same algorithm, bit-identical trees) when a toolchain is available,
    falling back to the NumPy implementation; 'native'/'numpy' force one.
    """

    def __init__(self, max_leaf_tris: int = MAX_LEAF_TRIS,
                 backend: str = "auto"):
        self.max_leaf_tris = max_leaf_tris
        self.backend = backend
        self._pos: List[np.ndarray] = []
        self._nrm: List[np.ndarray] = []
        self._uv: List[np.ndarray] = []
        self._slot: List[np.ndarray] = []
        self._nodes: List[tuple] = []  # (min, max, left, right, first, count)
        self.mesh_roots: List[int] = []
        self.mesh_root_aabbs: List[tuple] = []  # (min(3,), max(3,)) per mesh
        self.mesh_tri_ranges: List[tuple] = []  # (first, count) per mesh

    def build_mesh(self, surfaces: Sequence[Surface]) -> int:
        """Append one mesh's subtree; returns its root node index."""
        pos = np.concatenate([s.positions for s in surfaces], axis=0)
        nrm = np.concatenate([s.normals for s in surfaces], axis=0)
        uv = np.concatenate([s.uvs for s in surfaces], axis=0)
        slot = np.concatenate(
            [np.full(s.n_tris, i, dtype=np.int32) for i, s in enumerate(surfaces)]
        )
        n = len(pos)
        if n == 0:
            raise ValueError("mesh has no triangles")

        tri_base = sum(len(p) for p in self._pos)

        use_native = self.backend in ("auto", "native")
        if use_native:
            from gdpathtracing.bvh import native
            if native.available():
                root = self._build_mesh_native(pos, nrm, uv, slot, tri_base)
                return root
            if self.backend == "native":
                raise RuntimeError("native BVH builder unavailable")

        centroids = pos.mean(axis=1)
        tri_min = pos.min(axis=1)
        tri_max = pos.max(axis=1)
        order = np.arange(n)
        root = len(self._nodes)
        # Iterative top-down build with an explicit stack of (node_idx, lo, hi).
        self._nodes.append(None)  # placeholder for root
        stack = [(root, 0, n)]
        while stack:
            node_idx, lo, hi = stack.pop()
            idx = order[lo:hi]
            bmin = tri_min[idx].min(axis=0)
            bmax = tri_max[idx].max(axis=0)
            count = hi - lo

            split = None
            if count > self.max_leaf_tris:
                split = self._find_sah_split(centroids[idx], tri_min[idx],
                                             tri_max[idx], bmin, bmax)
                if split is None:
                    # SAH says leaf but leaf would exceed the bound:
                    # median split on the widest centroid axis.
                    axis = int(np.argmax(centroids[idx].max(0) - centroids[idx].min(0)))
                    part = np.argsort(centroids[idx][:, axis], kind="stable")
                    mid = count // 2
                    split = (part[:mid], part[mid:])
                else:
                    axis, plane = split
                    left_sel = centroids[idx][:, axis] < plane
                    if left_sel.all() or not left_sel.any():
                        # Degenerate partition → median fallback
                        # (bvh.cpp:170-177).
                        part = np.argsort(centroids[idx][:, axis], kind="stable")
                        mid = count // 2
                        split = (part[:mid], part[mid:])
                    else:
                        split = (np.nonzero(left_sel)[0], np.nonzero(~left_sel)[0])

            if split is None:
                self._nodes[node_idx] = (bmin, bmax, 0, 0, tri_base + lo, count)
                continue

            left_local, right_local = split
            order[lo:hi] = np.concatenate([idx[left_local], idx[right_local]])
            mid = lo + len(left_local)
            left_idx = len(self._nodes)
            right_idx = left_idx + 1
            self._nodes.append(None)
            self._nodes.append(None)
            self._nodes[node_idx] = (bmin, bmax, left_idx, right_idx, 0, 0)
            stack.append((right_idx, mid, hi))
            stack.append((left_idx, lo, mid))

        self._pos.append(pos[order])
        self._nrm.append(nrm[order])
        self._uv.append(uv[order])
        self._slot.append(slot[order])
        self.mesh_roots.append(root)
        rmin, rmax, *_ = self._nodes[root]
        self.mesh_root_aabbs.append((rmin.copy(), rmax.copy()))
        self.mesh_tri_ranges.append((tri_base, n))
        return root

    def _build_mesh_native(self, pos, nrm, uv, slot, tri_base) -> int:
        """Build via the C++ core and splice into the shared pools
        (subtree-local node/tri indices get the pool offsets)."""
        from gdpathtracing.bvh import native

        (nmin, nmax, left, right, first, count, order) = \
            native.build_blas_native(pos, self.max_leaf_tris)
        node_base = len(self._nodes)
        internal = count == 0
        for i in range(len(nmin)):
            if internal[i]:
                self._nodes.append((nmin[i], nmax[i],
                                    int(left[i]) + node_base,
                                    int(right[i]) + node_base, 0, 0))
            else:
                self._nodes.append((nmin[i], nmax[i], 0, 0,
                                    int(first[i]) + tri_base, int(count[i])))
        self._pos.append(pos[order])
        self._nrm.append(nrm[order])
        self._uv.append(uv[order])
        self._slot.append(slot[order])
        self.mesh_roots.append(node_base)
        self.mesh_root_aabbs.append((nmin[0].copy(), nmax[0].copy()))
        self.mesh_tri_ranges.append((tri_base, len(pos)))
        return node_base

    def _find_sah_split(self, cent, tmin, tmax, bmin, bmax):
        """8-bin SAH sweep over 3 axes (bvh.cpp:39-106). Returns
        (axis, plane) or None when no split beats the parent cost with the
        0.8 slack."""
        count = len(cent)
        parent_cost = _half_area(bmin, bmax) * count
        best_cost = np.inf
        best = None
        for axis in range(3):
            cmin = cent[:, axis].min()
            cmax = cent[:, axis].max()
            if cmax <= cmin:
                continue
            # float64 binning — the exact arithmetic the native C++ core
            # uses, so both builders produce bit-identical trees.
            scale = np.float64(BINS) / (np.float64(cmax) - np.float64(cmin))
            bin_idx = np.minimum(
                ((cent[:, axis].astype(np.float64) - np.float64(cmin))
                 * scale).astype(np.int64), BINS - 1)
            bin_counts = np.bincount(bin_idx, minlength=BINS)
            bin_min = np.full((BINS, 3), np.inf, dtype=np.float64)
            bin_max = np.full((BINS, 3), -np.inf, dtype=np.float64)
            for b in range(BINS):
                sel = bin_idx == b
                if sel.any():
                    bin_min[b] = tmin[sel].min(axis=0)
                    bin_max[b] = tmax[sel].max(axis=0)
            # Prefix (left) and suffix (right) scans over the 7 planes.
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(bin_counts)
            rcount = np.cumsum(bin_counts[::-1])[::-1]
            for i in range(BINS - 1):
                if lcount[i] == 0 or rcount[i + 1] == 0:
                    continue
                cost = (lcount[i] * _half_area(lmin[i], lmax[i]) +
                        rcount[i + 1] * _half_area(rmin[i + 1], rmax[i + 1]))
                if cost < best_cost:
                    best_cost = cost
                    best = (axis, np.float64(cmin) + (i + 1) / scale)
        if best is None or best_cost * SAH_SLACK >= parent_cost:
            return None
        return best

    def finalize(self) -> BLASArrays:
        if not self._nodes:
            raise ValueError("no meshes built")
        mins = np.stack([n[0] for n in self._nodes]).astype(np.float32)
        maxs = np.stack([n[1] for n in self._nodes]).astype(np.float32)
        ints = np.array([[n[2], n[3], n[4], n[5]] for n in self._nodes],
                        dtype=np.int32)
        return BLASArrays(
            node_min=mins,
            node_max=maxs,
            node_left=ints[:, 0],
            node_right=ints[:, 1],
            node_first=ints[:, 2],
            node_count=ints[:, 3],
            tri_pos=np.concatenate(self._pos, axis=0),
            tri_normal=np.concatenate(self._nrm, axis=0),
            tri_uv=np.concatenate(self._uv, axis=0),
            tri_slot=np.concatenate(self._slot, axis=0),
        )


def _half_area(bmin, bmax) -> float:
    e = np.maximum(np.asarray(bmax, dtype=np.float64) - bmin, 0.0)
    return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]


def validate_blas(arrays: BLASArrays, root: int) -> None:
    """Assert structural invariants of one subtree (used by tests):
    child AABBs inside parent, leaf triangle ranges within bounds and
    disjoint-covering, leaf size ≤ MAX_LEAF_TRIS."""
    seen_tris: list[tuple] = []
    stack = [root]
    eps = 1e-4
    while stack:
        i = stack.pop()
        if arrays.node_count[i] > 0:
            assert arrays.node_count[i] <= MAX_LEAF_TRIS
            first, cnt = int(arrays.node_first[i]), int(arrays.node_count[i])
            seen_tris.append((first, cnt))
            tp = arrays.tri_pos[first:first + cnt]
            assert (tp.reshape(-1, 3).min(axis=0) >= arrays.node_min[i] - eps).all()
            assert (tp.reshape(-1, 3).max(axis=0) <= arrays.node_max[i] + eps).all()
        else:
            for c in (arrays.node_left[i], arrays.node_right[i]):
                assert c != 0, "internal node with null child"
                assert (arrays.node_min[c] >= arrays.node_min[i] - eps).all()
                assert (arrays.node_max[c] <= arrays.node_max[i] + eps).all()
                stack.append(int(c))
    # Leaf ranges are disjoint and contiguous over the subtree's triangles.
    seen_tris.sort()
    for (f1, c1), (f2, _) in zip(seen_tris, seen_tris[1:]):
        assert f1 + c1 == f2, "leaf ranges not contiguous/disjoint"
