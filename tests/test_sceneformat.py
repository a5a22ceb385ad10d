"""JSON scene format + CLI round trip."""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from gdpathtracing.scene.sceneformat import (load_scene_file,
                                                 parse_transform)

SCENE = {
    "meshes": {
        "box": {"primitive": "cornell_box", "size": 5.0},
        "light": {"primitive": "plane", "size": 2.0},
        "ball": {"primitive": "uv_sphere", "radius": 1.0, "rings": 6,
                 "segments": 8},
    },
    "materials": {
        "grey": {"albedo": [1, 1, 1], "roughness": 0.6},
        "red": {"albedo": [1.0, 0.16, 0.16]},
        "green": {"albedo": [0.42, 1.0, 0.13]},
        "lamp": {"emission": [1, 1, 1], "emission_energy": 10},
        "mirror": {"metallic": 1.0, "roughness": 0.16},
    },
    "instances": [
        {"mesh": "light", "materials": "lamp",
         "transform": {"position": [0, 2.95, 0],
                       "rotation_deg": [180, 0, 0]}},
        {"mesh": "box", "materials": ["grey", "red", "green"],
         "transform": {"rotation_deg": [0, 90, 0], "scale": 0.6}},
        {"mesh": "ball", "material_override": "mirror",
         "transform": {"position": [1.2, -1.0, -0.9]}},
    ],
    "camera": {"position": [0, 0, 9.77], "look_at": [0, 0, 0], "fov": 79.5},
}


def test_parse_transform_forms():
    t = parse_transform([1, 0, 0, 5, 0, 1, 0, 6, 0, 0, 1, 7])
    assert np.allclose(t[:, 3], [5, 6, 7])
    t2 = parse_transform({"position": [1, 2, 3], "scale": 2.0})
    assert np.allclose(t2[:, :3], np.eye(3) * 2.0)
    t3 = parse_transform({"rotation_deg": [0, 90, 0]})
    # +Z axis maps to +X under 90° yaw (column convention)
    assert np.allclose(t3[:, :3] @ np.array([0, 0, 1.0]), [1, 0, 0],
                       atol=1e-6)


def test_load_scene_file(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE))
    scene, camera = load_scene_file(p, width=64, height=48)
    assert scene.n_instances == 3
    assert camera.width == 64
    assert float(np.asarray(camera.position.z)) > 9.0
    # material override applied to the ball instance
    mats = np.asarray(scene.inst_materials)
    alb = np.asarray(scene.mat_albedo)
    metallic = np.asarray(scene.mat_metallic)
    assert metallic[mats[2][0]] == 1.0
    # per-surface split on the box
    assert np.allclose(alb[mats[1][1]], [1.0, 0.16, 0.16])


def test_cli_render_and_info(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE))
    out = tmp_path / "img.png"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""  # let the subprocess choose; conftest n/a
    code = f"""
import jax
jax.config.update('jax_platforms', 'cpu')
from gdpathtracing.cli import main
main(['render', r'{p}', '--out', r'{out}', '--width', '32',
      '--height', '32', '--frames', '2', '--bounces', '2',
      '--traversal', 'unit'])
main(['info', r'{p}'])
"""
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.exists()
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert '"instances": 3' in res.stdout


def test_png_texture_roundtrip(tmp_path):
    """write_png → _decode_png round trip, then into a textured scene."""
    from gdpathtracing.cli import write_png
    from gdpathtracing.scene.sceneformat import _decode_png
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, size=(16, 16, 3), dtype=np.uint8)
    p = tmp_path / "t.png"
    write_png(p, img)
    back = _decode_png(p.read_bytes())
    assert np.array_equal(img, back)

    spec = dict(SCENE)
    spec["materials"] = dict(SCENE["materials"])
    spec["materials"]["tex"] = {"albedo": [1, 1, 1],
                                "albedo_texture": "t.png"}
    spec["instances"] = [
        {"mesh": "ball", "material_override": "tex"}] + SCENE["instances"][:1]
    sp = tmp_path / "s.json"
    sp.write_text(json.dumps(spec))
    scene, _ = load_scene_file(sp, texture_resolution=8)
    assert scene.textures.shape == (1, 8, 8, 3)
