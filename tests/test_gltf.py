"""glTF loader: build a synthetic .gltf + .glb in-test and load them."""

import base64
import json
import struct

import numpy as np

from gdpathtracing.scene.gltfloader import GLTF, load_gltf_scene


def _make_gltf_doc(binary: bytes, embed: bool):
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                         np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    buf = (positions.tobytes() + normals.tobytes() + uvs.tobytes() +
           indices.tobytes())
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1, 2, 3],
                   "scale": [2, 2, 2]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.7}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(buf)}],
    }
    if embed:
        doc["buffers"][0]["uri"] = (
            "data:application/octet-stream;base64," +
            base64.b64encode(buf).decode())
    return doc, buf


def test_gltf_json_embedded(tmp_path):
    doc, _ = _make_gltf_doc(b"", embed=True)
    p = tmp_path / "quad.gltf"
    p.write_text(json.dumps(doc))
    g = GLTF(p)
    surfaces, mats = g.mesh_surfaces(0)
    assert len(surfaces) == 1
    assert surfaces[0].n_tris == 2
    assert np.allclose(surfaces[0].normals, [0, 0, 1])
    assert mats[0].albedo == (0.9, 0.5, 0.25)
    assert mats[0].roughness == 0.7
    nodes = g.node_transforms()
    assert len(nodes) == 1
    _, tf = nodes[0]
    assert np.allclose(tf[:, 3], [1, 2, 3])
    assert np.allclose(tf[:, :3], np.eye(3) * 2)


def test_glb_container(tmp_path):
    doc, buf = _make_gltf_doc(b"", embed=False)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binchunk = buf + b"\x00" * (-len(buf) % 4)
    glb = (struct.pack("<III", 0x46546C67, 2,
                       12 + 8 + len(js) + 8 + len(binchunk)) +
           struct.pack("<II", len(js), 0x4E4F534A) + js +
           struct.pack("<II", len(binchunk), 0x004E4942) + binchunk)
    p = tmp_path / "quad.glb"
    p.write_bytes(glb)
    scene = load_gltf_scene(p, texture_resolution=4)
    assert scene.n_tris == 2
    assert scene.n_instances == 1
    # material 0 is default; the quad's material follows
    mat = np.asarray(scene.mat_albedo)[
        np.asarray(scene.inst_materials)[0, 0]]
    assert np.allclose(mat, [0.9, 0.5, 0.25])
