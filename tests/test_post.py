"""Post-processing: ACES, progressive accumulation semantics, temporal
reprojection identity case."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.post.progressive import (progressive_init,
                                                progressive_update)
from gdpathtracing.post.temporal import (nonlinear_depth, temporal_init,
                                             temporal_update)
from gdpathtracing.post.tonemap import aces_film


def test_aces_range_and_monotone():
    x = jnp.linspace(0.0, 20.0, 100)
    y = np.asarray(aces_film(x))
    assert (y >= 0).all() and (y <= 1).all()
    assert (np.diff(y) >= -1e-6).all()
    assert y[-1] > 0.99  # saturates to white
    assert float(aces_film(jnp.float32(0.0))) == 0.0


def test_progressive_accumulates_while_still():
    state = progressive_init(4, 4)
    tf = jnp.zeros((3, 4), jnp.float32)
    frames = [jnp.full((4, 4, 3), v, jnp.float32) for v in (1.0, 3.0)]
    img1, state = progressive_update(state, frames[0], tf)
    assert int(state.frame_count) == 1
    img2, state = progressive_update(state, frames[1], tf)
    assert int(state.frame_count) == 2
    # Linear average = 2.0 (display transform is a separate stage)
    assert np.allclose(np.asarray(img2), 2.0, atol=1e-6)


def test_progressive_resets_on_motion():
    state = progressive_init(2, 2)
    tf1 = jnp.zeros((3, 4), jnp.float32)
    tf2 = tf1.at[0, 3].set(1.0)  # moved camera
    _, state = progressive_update(state, jnp.ones((2, 2, 3)), tf1)
    _, state = progressive_update(state, jnp.ones((2, 2, 3)), tf1)
    assert int(state.frame_count) == 2
    _, state = progressive_update(state, jnp.ones((2, 2, 3)) * 5, tf2)
    assert int(state.frame_count) == 1
    assert np.allclose(np.asarray(state.accum), 5.0)


def test_temporal_static_camera_blends_history():
    h = w = 4
    state = temporal_init(w, h)
    vp = jnp.eye(4, dtype=jnp.float32)
    depth = jnp.full((h, w), 0.5, jnp.float32)
    a = jnp.ones((h, w, 3), jnp.float32)
    b = jnp.zeros((h, w, 3), jnp.float32)
    img1, state = temporal_update(state, a, depth, vp)
    # First frame: no history accepted (frame_count==0) → blended == current.
    assert np.allclose(np.asarray(state.history), 1.0)
    img2, state = temporal_update(state, b, depth, vp)
    # Static camera, identity reprojection: blended = mix(0, 1, 0.75) = 0.75.
    assert np.allclose(np.asarray(state.history), 0.75, atol=1e-5)


def test_nonlinear_depth_reversed_z():
    near, far = 0.01, 1000.0
    d = nonlinear_depth(jnp.asarray([near, far]), near, far)
    assert abs(float(d[0]) - 0.0) < 1e-4
    assert abs(float(d[1]) - (far / (far - near) * (1 - near / far))) < 1e-4


def test_display_transform_modes():
    from gdpathtracing.config import RenderConfig, Tonemap
    from gdpathtracing.post.display import display_transform
    img = jnp.full((8, 8, 3), 0.5, jnp.float32)
    aces = display_transform(img, RenderConfig())
    lin = display_transform(img, RenderConfig(tonemap=Tonemap.LINEAR))
    rein = display_transform(img, RenderConfig(tonemap=Tonemap.REINHARD))
    assert np.allclose(np.asarray(lin), 0.5)
    assert np.allclose(np.asarray(rein), 0.5 / 1.5, atol=1e-6)
    assert not np.allclose(np.asarray(aces), np.asarray(lin))
    # exposure doubles pre-tonemap
    ex = display_transform(img, RenderConfig(tonemap=Tonemap.LINEAR,
                                             exposure=2.0))
    assert np.allclose(np.asarray(ex), 1.0)


def test_bloom_spreads_highlights():
    from gdpathtracing.config import RenderConfig
    from gdpathtracing.post.display import bloom
    img = np.zeros((17, 17, 3), np.float32)
    img[8, 8] = 20.0
    out = np.asarray(bloom(jnp.asarray(img), threshold=1.0, strength=0.5,
                           radius=4))
    assert out[8, 8, 0] > 20.0        # peak keeps its energy + bloom
    assert out[8, 10, 0] > 0.01       # neighbors lit
    assert out[0, 0, 0] < 1e-4        # far corner untouched


def test_atrous_denoiser_reduces_noise_keeps_edges():
    from gdpathtracing.post.denoise import atrous_denoise
    rs = np.random.RandomState(0)
    h = w = 32
    # two flat regions separated by a depth+normal edge, plus noise
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:] = 1.0
    noisy = clean + rs.normal(0, 0.2, size=clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    depth = np.where(np.arange(w)[None, :] < w // 2, 5.0, 10.0)
    depth = np.broadcast_to(depth, (h, w)).astype(np.float32)
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), jnp.asarray(normal),
                                    jnp.asarray(depth)))
    # noise reduced within each region
    left = slice(4, h - 4), slice(4, w // 2 - 4)
    right = slice(4, h - 4), slice(w // 2 + 4, w - 4)
    assert out[left].std() < 0.5 * noisy[left].std()
    assert out[right].std() < 0.5 * noisy[right].std()
    # edge preserved (no bleed across): means stay far apart
    assert out[right].mean() - out[left].mean() > 0.8
