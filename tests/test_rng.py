"""PCG2D must match a direct scalar emulation of main.glsl:163-181."""

import numpy as np
import jax.numpy as jnp

from gdpathtracing.core import rng

M = 0xFFFFFFFF


def _pcg2d_ref(sx, sy):
    A, C = 1664525, 1013904223
    sx = (sx * A + C) & M
    sy = (sy * A + C) & M
    sx = (sx + sy * A) & M
    sy = (sy + sx * A) & M
    sx ^= sx >> 16
    sy ^= sy >> 16
    sx = (sx + sy * A) & M
    sy = (sy + sx * A) & M
    sx ^= sx >> 16
    sy ^= sy >> 16
    return sx, sy


def _seed_ref(px, py, frame):
    G = 0x9E3779B9
    sx = (px * G + frame) & M
    sy = (py * G + frame) & M
    sx ^= sx >> 16
    sy ^= sy >> 16
    return (sx * G) & M, (sy * G) & M


def test_pcg2d_matches_reference_bits():
    xs = np.array([0, 1, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
    ys = np.array([7, 99, 54321, 0xCAFEBABE, 1], dtype=np.uint32)
    (u, v), (nx, ny) = rng.pcg2d((jnp.asarray(xs), jnp.asarray(ys)))
    for i in range(len(xs)):
        ex, ey = _pcg2d_ref(int(xs[i]), int(ys[i]))
        assert int(nx[i]) == ex
        assert int(ny[i]) == ey
        assert abs(float(u[i]) - ex * 2.32830643654e-10) < 1e-7
        assert abs(float(v[i]) - ey * 2.32830643654e-10) < 1e-7


def test_prng_seed_matches_reference_bits():
    px = np.array([0, 3, 1919], dtype=np.uint32)
    py = np.array([0, 7, 1079], dtype=np.uint32)
    for frame in (0, 1, 123456):
        sx, sy = rng.prng_seed(jnp.asarray(px), jnp.asarray(py), frame)
        for i in range(len(px)):
            ex, ey = _seed_ref(int(px[i]), int(py[i]), frame)
            assert int(sx[i]) == ex
            assert int(sy[i]) == ey


def test_uniformity():
    n = 50000
    seed = rng.prng_seed(jnp.arange(n, dtype=jnp.uint32),
                         jnp.arange(n, dtype=jnp.uint32) * 7 + 1, 0)
    (u, v), _ = rng.pcg2d(seed)
    u = np.asarray(u)
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(np.var(u) - 1 / 12) < 0.005
