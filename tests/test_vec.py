import numpy as np
import jax.numpy as jnp

from gdpathtracing.core.vec import Vec3, lerp, reflect, where


def _v(arr):
    return Vec3.from_array(jnp.asarray(arr, dtype=jnp.float32))


def test_arithmetic_and_dot_cross():
    a = _v([[1.0, 2.0, 3.0], [0.0, -1.0, 2.0]])
    b = _v([[4.0, 5.0, 6.0], [1.0, 1.0, 1.0]])
    assert np.allclose((a + b).to_array(), [[5, 7, 9], [1, 0, 3]])
    assert np.allclose((a * 2.0).to_array(), [[2, 4, 6], [0, -2, 4]])
    assert np.allclose(a.dot(b), [32.0, 1.0])
    c = a.cross(b)
    for i in range(2):
        expected = np.cross(np.asarray(a.to_array())[i],
                            np.asarray(b.to_array())[i])
        assert np.allclose(np.asarray(c.to_array())[i], expected)


def test_normalize_and_length():
    a = _v([[3.0, 0.0, 4.0]])
    assert np.allclose(a.length(), [5.0])
    n = a.normalize()
    assert np.allclose(n.to_array(), [[0.6, 0.0, 0.8]])


def test_where_lerp_reflect():
    a = _v([[1.0, 1.0, 1.0]])
    b = _v([[0.0, 2.0, 4.0]])
    m = jnp.array([True])
    assert np.allclose(where(m, a, b).to_array(), [[1, 1, 1]])
    assert np.allclose(lerp(a, b, 0.5).to_array(), [[0.5, 1.5, 2.5]])
    d = _v([[1.0, -1.0, 0.0]]).normalize()
    n = _v([[0.0, 1.0, 0.0]])
    r = reflect(d, n)
    assert np.allclose(r.to_array(), np.asarray([[1.0, 1.0, 0.0]]) / np.sqrt(2),
                       atol=1e-6)
