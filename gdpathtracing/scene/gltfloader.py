"""Minimal glTF 2.0 loader (.gltf / .glb) → SceneBuilder input.

Covers the asset shapes the framework targets (BASELINE config 2: a single
character mesh with an albedo texture): triangle primitives with
POSITION / NORMAL / TEXCOORD_0 + indices, pbrMetallicRoughness materials
(baseColorFactor/Texture, metallic/roughness factors, emissive), node
hierarchy with TRS or matrix transforms, external / embedded (data URI) /
GLB-chunk buffers, PNG textures.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path
from typing import List

import numpy as np

from gdpathtracing.bvh.blas import Surface
from gdpathtracing.scene.materials import Material
from gdpathtracing.scene.scene import Scene, SceneBuilder

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTF:
    def __init__(self, path: str | Path):
        path = Path(path)
        self.base = path.parent
        data = path.read_bytes()
        if data[:4] == b"glTF":  # GLB container
            _, version, _ = struct.unpack("<III", data[:12])
            assert version == 2, f"unsupported GLB version {version}"
            off = 12
            self.doc = None
            self.bin = b""
            while off < len(data):
                ln, tag = struct.unpack("<II", data[off:off + 8])
                chunk = data[off + 8:off + 8 + ln]
                off += 8 + ln
                if tag == 0x4E4F534A:  # JSON
                    self.doc = json.loads(chunk)
                elif tag == 0x004E4942:  # BIN
                    self.bin = chunk
        else:
            self.doc = json.loads(data)
            self.bin = b""
        self._buffers = {}

    def buffer(self, idx: int) -> bytes:
        if idx not in self._buffers:
            spec = self.doc["buffers"][idx]
            uri = spec.get("uri")
            if uri is None:
                self._buffers[idx] = self.bin
            elif uri.startswith("data:"):
                self._buffers[idx] = base64.b64decode(uri.split(",", 1)[1])
            else:
                self._buffers[idx] = (self.base / uri).read_bytes()
        return self._buffers[idx]

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffer(view["buffer"])
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dtype.itemsize * ncomp
        if stride == dtype.itemsize * ncomp:
            out = np.frombuffer(buf, dtype=dtype, count=count * ncomp,
                                offset=offset).reshape(count, ncomp)
        else:
            raw = np.frombuffer(buf, dtype=np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                raw[offset:], shape=(count, dtype.itemsize * ncomp),
                strides=(stride, 1))
            out = rows.copy().view(dtype).reshape(count, ncomp)
        return out

    def image(self, idx: int) -> np.ndarray:
        from gdpathtracing.scene.sceneformat import _decode_png
        spec = self.doc["images"][idx]
        if "bufferView" in spec:
            view = self.doc["bufferViews"][spec["bufferView"]]
            buf = self.buffer(view["buffer"])
            off = view.get("byteOffset", 0)
            data = buf[off:off + view["byteLength"]]
        elif spec.get("uri", "").startswith("data:"):
            data = base64.b64decode(spec["uri"].split(",", 1)[1])
        else:
            data = (self.base / spec["uri"]).read_bytes()
        if data[:8] != b"\x89PNG\r\n\x1a\n":
            raise ValueError("only PNG textures supported")
        return _decode_png(data)

    def material(self, idx: int | None) -> Material | None:
        if idx is None:
            return None
        m = self.doc.get("materials", [])[idx]
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        tex = None
        if "baseColorTexture" in pbr:
            tex_idx = self.doc["textures"][
                pbr["baseColorTexture"]["index"]]["source"]
            tex = self.image(tex_idx)
        mr_tex = None
        if "metallicRoughnessTexture" in pbr:
            mr_idx = self.doc["textures"][
                pbr["metallicRoughnessTexture"]["index"]]["source"]
            mr_tex = self.image(mr_idx)
        emissive = m.get("emissiveFactor", [0, 0, 0])
        energy = 1.0 if any(e > 0 for e in emissive) else 0.0
        return Material(
            albedo=tuple(base[:3]),
            emission=tuple(emissive),
            emission_energy=energy,
            metallic=pbr.get("metallicFactor", 1.0 if pbr else 0.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            albedo_texture=tex,
            metallic_roughness_texture=mr_tex,
        )

    def mesh_surfaces(self, idx: int):
        """→ (surfaces, materials) for mesh `idx` (one surface per
        primitive, matching the per-surface material table design)."""
        surfaces: List[Surface] = []
        mats: List[Material | None] = []
        for prim in self.doc["meshes"][idx]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = self.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                ind = self.accessor(prim["indices"]).reshape(-1)
            else:
                ind = np.arange(len(pos))
            ind = ind.astype(np.int64).reshape(-1, 3)
            p = pos[ind]
            n = None
            if "NORMAL" in attrs:
                n = self.accessor(attrs["NORMAL"]).astype(np.float32)[ind]
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = self.accessor(attrs["TEXCOORD_0"]).astype(np.float32)[ind]
            surfaces.append(Surface(positions=p, normals=n, uvs=uv))
            mats.append(self.material(prim.get("material")))
        return surfaces, mats

    def node_transforms(self):
        """Flatten the node hierarchy → [(mesh_idx, (3,4) world affine)]."""
        doc = self.doc
        out = []

        def local(node) -> np.ndarray:
            if "matrix" in node:
                m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
                return m
            m = np.eye(4, dtype=np.float32)
            s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
            r = node.get("rotation")  # xyzw quaternion
            rot = np.eye(3, dtype=np.float32)
            if r is not None:
                x, y, z, w = r
                rot = np.array([
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ], dtype=np.float32)
            m[:3, :3] = rot * s[None, :]
            m[:3, 3] = node.get("translation", [0, 0, 0])
            return m

        def walk(node_idx, parent):
            node = doc["nodes"][node_idx]
            world = parent @ local(node)
            if "mesh" in node:
                out.append((node["mesh"], world[:3, :]))
            for c in node.get("children", []):
                walk(c, world)

        scene_idx = doc.get("scene", 0)
        roots = doc.get("scenes", [{"nodes": []}])[scene_idx].get("nodes", [])
        for r in roots:
            walk(r, np.eye(4, dtype=np.float32))
        if not out and doc.get("meshes"):
            # No scene graph: instance every mesh at identity.
            out = [(i, np.eye(4, dtype=np.float32)[:3])
                   for i in range(len(doc["meshes"]))]
        return out


def load_gltf_scene(path: str | Path, texture_resolution: int = 512) -> Scene:
    """Load a .gltf/.glb file into a Scene (all mesh nodes instanced)."""
    g = GLTF(path)
    builder = SceneBuilder(texture_resolution=texture_resolution)
    mesh_cache = {}
    for mesh_idx, transform in g.node_transforms():
        if mesh_idx not in mesh_cache:
            surfaces, mats = g.mesh_surfaces(mesh_idx)
            mesh_cache[mesh_idx] = (builder.add_mesh(surfaces), mats)
        mid, mats = mesh_cache[mesh_idx]
        builder.add_instance(mid, transform, materials=mats)
    return builder.build()
