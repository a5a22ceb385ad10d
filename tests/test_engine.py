"""Engine frame loop, checkpointing, and stats utilities."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing import Engine, RenderConfig
from gdpathtracing.config import DenoisingMode, Traversal
from gdpathtracing.post.checkpoint import load_state, save_state
from gdpathtracing.post.progressive import ProgressiveState
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.demo import build_cornell_simple, demo_camera
from gdpathtracing.utils.stats import frame_stats, steps_heatmap

CFG = RenderConfig(bounces=2, spp=1, traversal=Traversal.UNIT)


def test_engine_progressive_accumulates():
    scene = build_cornell_simple()
    cam = demo_camera(24, 24)
    eng = Engine(scene, CFG)
    img1 = np.asarray(eng.step(cam))
    assert img1.shape == (24, 24, 3)
    assert (img1 >= 0).all() and (img1 <= 1).all()
    for _ in range(3):
        img = eng.step(cam)
    assert eng.frame_index == 4
    assert int(eng._state.frame_count) == 4
    u8 = eng.to_uint8(img)
    assert u8.dtype == np.uint8


def test_engine_reset_on_new_camera_is_manual():
    scene = build_cornell_simple()
    cam = demo_camera(16, 16)
    eng = Engine(scene, CFG.replace(denoising=DenoisingMode.NONE))
    img = eng.step(cam)
    assert np.isfinite(np.asarray(img)).all()


def test_checkpoint_roundtrip(tmp_path):
    state = ProgressiveState(
        accum=jnp.arange(12.0).reshape(2, 2, 3),
        frame_count=jnp.int32(7),
        prev_transform=jnp.ones((3, 4)),
    )
    p = tmp_path / "ckpt.npz"
    save_state(p, state)
    like = ProgressiveState(jnp.zeros((2, 2, 3)), jnp.int32(0),
                            jnp.zeros((3, 4)))
    back = load_state(p, like)
    assert int(back.frame_count) == 7
    assert np.allclose(np.asarray(back.accum),
                       np.arange(12.0).reshape(2, 2, 3))


def test_frame_stats_and_heatmap():
    scene = build_cornell_simple()
    cam = demo_camera(16, 16)
    aovs = render_radiance(scene, cam, CFG, 0)
    st = frame_stats(aovs, spp=1, elapsed_s=1.0)
    assert st.rays > 16 * 16  # multi-bounce
    assert 1.0 <= st.mean_path_length <= CFG.bounces
    assert st.mrays_per_s == st.rays / 1e6
    hm = np.asarray(steps_heatmap(aovs))
    assert hm.shape == (16, 16, 3)
    assert (hm >= 0).all() and (hm <= 1).all()


def test_viewer_orbit_loop():
    """The interactive frame loop (examples/viewer.py) in scripted-orbit
    mode: real camera motion through Engine + temporal reprojection each
    frame — the reference's moving-camera regime (movable_camera.gd)."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    out = root / "out" / "viewer_test.png"
    r = subprocess.run(
        [sys.executable, str(root / "examples" / "viewer.py"),
         "--script", "orbit", "--frames", "4", "--res", "32",
         "--traversal", "unit", "--cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
