"""Scene compilation: builder, material dedupe/resolution, OBJ loader,
primitives winding, demo scene assembly."""

import os
import tempfile

import numpy as np
import jax

from gdpathtracing.scene.demo import build_demo_scene
from gdpathtracing.scene.materials import Material
from gdpathtracing.scene.objloader import load_obj
from gdpathtracing.scene.primitives import (cornell_box, plane_mesh,
                                                uv_sphere)
from gdpathtracing.scene.scene import SceneBuilder


def test_demo_scene_shapes():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=4, geometry="sphere")
    assert scene.n_instances == 4
    # light(1 surf) + box(3 surf) + 2 spheres(1 surf)
    assert scene.inst_materials.shape[0] == 4
    assert scene.n_tris == int(np.asarray(scene.tri_pos).shape[0])
    # Two sphere instances share one BLAS root.
    roots = np.asarray(scene.inst_root)
    assert roots[2] == roots[3]
    # Material 0 is the default grey.
    assert np.allclose(np.asarray(scene.mat_albedo)[0], 0.5)


def test_demo_scene_reference_geometry():
    """Default demo geometry is the REAL reference demo (demo.tscn:69-93):
    cornell.obj (3 surfaces, 10 tris) + 2 instances of suzanne.obj
    (968 tris) sharing one BLAS, + the plane light."""
    from gdpathtracing.scene.demo import load_demo_geometry
    cornell = load_demo_geometry("cornell")
    suzanne = load_demo_geometry("suzanne")
    assert len(cornell) == 3
    assert sum(s.positions.shape[0] for s in cornell) == 10
    assert len(suzanne) == 1
    assert suzanne[0].positions.shape[0] == 968
    assert suzanne[0].normals is not None  # smooth-shaded monkey

    scene = build_demo_scene(texture_resolution=8)
    assert scene.n_instances == 4
    assert scene.n_tris == 2 + 10 + 968  # light + cornell + ONE suzanne
    roots = np.asarray(scene.inst_root)
    assert roots[2] == roots[3]  # instanced suzannes share a BLAS
    # expanded isect table: light 2 + cornell 10 + 2×suzanne
    nonpad = np.abs(np.asarray(scene.isect_mw)).sum(axis=0) > 0
    assert nonpad.sum() == 2 + 10 + 2 * 968
    assert scene.n_lights > 0  # ceiling light + emissive suzanne


def test_scene_is_pytree():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=4, geometry="sphere")
    leaves = jax.tree_util.tree_leaves(scene)
    assert len(leaves) > 20
    # static fields not leaves
    assert all(not isinstance(l, tuple) for l in leaves)


def test_material_dedupe():
    b = SceneBuilder()
    m1 = Material(albedo=(1, 0, 0))
    m2 = Material(albedo=(1, 0, 0))
    m3 = Material(albedo=(0, 1, 0))
    assert b.material_id(m1) == b.material_id(m2)
    assert b.material_id(m3) != b.material_id(m1)
    assert b.material_id(None) == 0


def test_material_override_precedence():
    b = SceneBuilder()
    mesh = b.add_mesh(cornell_box())
    override = Material(albedo=(0.1, 0.2, 0.3))
    per_surf = Material(albedo=(0.9, 0.9, 0.9))
    b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3],
                   materials=[per_surf, per_surf, per_surf],
                   material_override=override)
    scene = b.build()
    oid = np.asarray(scene.inst_materials)[0]
    albedo = np.asarray(scene.mat_albedo)[oid[0]]
    assert np.allclose(albedo, (0.1, 0.2, 0.3))
    assert (oid == oid[0]).all()


def test_primitives_windings_match_normals():
    for surfs in (cornell_box(), plane_mesh(), uv_sphere(rings=6, segments=8)):
        for s in surfs:
            e1 = s.positions[:, 1] - s.positions[:, 0]
            e2 = s.positions[:, 2] - s.positions[:, 0]
            geom = np.cross(e1, e2)
            avg_n = s.normals.mean(axis=1)
            dots = (geom * avg_n).sum(axis=1)
            assert (dots > 0).all()


def test_obj_loader_quads_and_groups():
    obj = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
usemtl a
f 1/1/1 2/1/1 3/1/1 4/1/1
usemtl b
f 1/1/1 3/1/1 4/1/1
"""
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write(obj)
        path = f.name
    try:
        surfs = load_obj(path)
        assert len(surfs) == 2
        assert surfs[0].n_tris == 2  # quad → 2 tris
        assert surfs[1].n_tris == 1
        assert np.allclose(surfs[0].normals, [0, 0, 1])
    finally:
        os.unlink(path)


def test_obj_loader_negative_indices_and_missing_normals():
    obj = """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
"""
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write(obj)
        path = f.name
    try:
        surfs = load_obj(path)
        assert len(surfs) == 1
        # computed face normal +z
        assert np.allclose(surfs[0].normals, [0, 0, 1])
    finally:
        os.unlink(path)


def test_texture_array_assembly():
    b = SceneBuilder(texture_resolution=4)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :, 0] = 255
    mesh = b.add_mesh(plane_mesh())
    b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3],
                   materials=[Material(albedo=(1, 1, 1), albedo_texture=tex)])
    scene = b.build()
    assert scene.textures.shape == (1, 4, 4, 3)
    assert np.allclose(np.asarray(scene.textures)[0, :, :, 0], 1.0)
    assert int(np.asarray(scene.mat_tex)[1]) == 0  # slot 1 (0=default)


def test_environment_map_sky():
    import jax.numpy as jnp
    from gdpathtracing.core.vec import Vec3
    from gdpathtracing.render.sky import sample_environment, sample_sky
    from gdpathtracing.config import RenderConfig
    from gdpathtracing.scene.primitives import plane_mesh

    env = np.zeros((4, 8, 3), np.float32)
    env[0] = [0, 0, 1]   # zenith blue
    env[3] = [0, 1, 0]   # nadir green
    b = SceneBuilder()
    mesh = b.add_mesh(plane_mesh())
    b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3])
    b.set_environment(env, energy=2.0)
    scene = b.build()
    assert scene.has_env
    up = Vec3(jnp.zeros(1), jnp.ones(1), jnp.zeros(1))
    down = Vec3(jnp.zeros(1), -jnp.ones(1), jnp.zeros(1))
    c_up = np.asarray(sample_sky(up, RenderConfig(), scene).to_array())[0]
    c_dn = np.asarray(sample_sky(down, RenderConfig(), scene).to_array())[0]
    assert c_up[2] > c_up[1]   # blue up
    assert c_dn[1] > c_dn[2]   # green down
    assert c_up.max() > 1.0    # energy multiplier applied


def test_hdr_decoder(tmp_path):
    from gdpathtracing.scene.hdr import load_hdr
    # flat (non-RLE) 2x2 .hdr file built by hand
    import struct
    rgbe = np.array([
        [[128, 0, 0, 129], [0, 128, 0, 129]],
        [[0, 0, 128, 129], [128, 128, 128, 130]],
    ], dtype=np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n"
    p = tmp_path / "t.hdr"
    p.write_bytes(header + rgbe.tobytes())
    img = load_hdr(p)
    assert img.shape == (2, 2, 3)
    # (128+0.5)*2^(129-136) = 128.5/128 ≈ 1.0
    assert abs(img[0, 0, 0] - 1.004) < 0.01
    assert img[0, 0, 1] < 0.01
    assert abs(img[1, 1, 0] - 2.008) < 0.02  # exponent 130 → x2


def test_metallic_roughness_texture():
    import jax.numpy as jnp
    from gdpathtracing.render.intersect import trace_unit
    from gdpathtracing.render.shading import get_shading_data
    from gdpathtracing.render.types import Ray
    from gdpathtracing.core.vec import Vec3

    # G=0.5 (roughness), B=1.0 (metallic)
    mr = np.zeros((4, 4, 3), np.float32)
    mr[:, :, 1] = 0.5
    mr[:, :, 2] = 1.0
    b = SceneBuilder(texture_resolution=4)
    mesh = b.add_mesh(plane_mesh(size=4.0))
    b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3],
                   materials=[Material(albedo=(1, 1, 1), metallic=1.0,
                                       roughness=0.8,
                                       metallic_roughness_texture=mr)])
    scene = b.build()
    assert int(np.asarray(scene.mat_mr_tex)[1]) >= 0
    ray = Ray(Vec3(jnp.zeros(4), jnp.ones(4) * 2, jnp.zeros(4)),
              Vec3(jnp.zeros(4), -jnp.ones(4), jnp.zeros(4)))
    hit = trace_unit(scene, ray)
    assert (np.asarray(hit.t) < 1e8).all()
    for fast in (False, True):
        s = get_shading_data(scene, hit, ray, fast=fast)
        assert np.allclose(np.asarray(s.roughness), 0.4, atol=1e-3), fast
        # metallic 1.0 * B 1.0 → fully metallic: diffuse goes to 0
        assert np.allclose(np.asarray(s.diffuse_albedo.to_array()), 0.0,
                           atol=1e-3), fast
