"""Legacy test-signal / trace helpers vs literal NumPy ports of the MATLAB."""
import jax
import jax.numpy as jnp
import numpy as np

from semiblind_tv.utils import (
    calctv,
    ensure,
    make_rd_squares,
    monotonize,
    sparse_pws,
    vectorized_operator,
)
from tests.oracles import np_calctv, np_monotonize, np_rd_squares, np_sparse_pws


def test_calctv_matches_oracle():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(13, 9))
    tv, vmax = calctv(jnp.asarray(X))
    tv0, vmax0 = np_calctv(X)
    np.testing.assert_allclose(float(tv), tv0, rtol=1e-12)
    np.testing.assert_allclose(float(vmax), vmax0, rtol=1e-12)


def test_calctv_flat_column_major():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(7, 11))
    flat = X.flatten(order="F")  # MATLAB vectorisation
    tv, vmax = calctv(jnp.asarray(flat), shape=X.shape)
    tv0, vmax0 = np_calctv(X)
    np.testing.assert_allclose(float(tv), tv0, rtol=1e-12)
    np.testing.assert_allclose(float(vmax), vmax0, rtol=1e-12)


def test_monotonize_matches_loop_port():
    rng = np.random.default_rng(2)
    x = rng.normal(size=50).cumsum() + rng.normal(size=50)
    y = np.asarray(monotonize(jnp.asarray(x)))
    y0 = np_monotonize(x)
    np.testing.assert_allclose(y, y0, rtol=1e-12)
    assert np.all(np.diff(y) >= -1e-12)  # non-decreasing
    assert y[0] == x[0]


def test_sparse_pws_matches_oracle_geometry():
    N, L, n = 32, 6, 5
    rng = np.random.default_rng(3)
    corners = np.round(rng.uniform(size=(L, 2)) * N).astype(int)
    got = np.asarray(sparse_pws(jax.random.key(0), N, L, n, corners=corners))
    want = np_sparse_pws(corners, N, n)
    np.testing.assert_array_equal(got, want)
    # boundary clamps: corner 0 and corner N both stay in-canvas
    edge = np.array([[0, N], [N, 0]])
    got_e = np.asarray(sparse_pws(jax.random.key(0), N, 2, n, corners=edge))
    np.testing.assert_array_equal(got_e, np_sparse_pws(edge, N, n))


def test_sparse_pws_random_draw_reasonable():
    x = np.asarray(sparse_pws(jax.random.key(7), 64, 4, 6))
    assert set(np.unique(x)) <= {0.0, 1.0}
    assert 0 < x.sum() <= 4 * 36


def test_make_rd_squares_matches_oracle():
    N, nbs, dyna = 64, 4, 40.0
    rng = np.random.default_rng(4)
    draws = rng.uniform(size=(nbs, 5))
    got = np.asarray(make_rd_squares(jax.random.key(0), N, nbs, dyna, draws=draws))
    want = np_rd_squares(draws, N, nbs, dyna)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    supp = got > 0
    assert np.isclose(got[supp].min(), 1.0)
    assert np.isclose(got[supp].max(), 10 ** (dyna / 20.0))


def test_vectorized_operator_roundtrip():
    rng = np.random.default_rng(5)
    K = jnp.asarray(rng.normal(size=(6, 4)))  # maps 4-col images to 6-col

    A = lambda img: img @ K.T  # (3,4) -> (3,6)
    AT = lambda img: img @ K  # (3,6) -> (3,4)

    op = vectorized_operator(A, AT, in_shape=(3, 4), out_shape=(3, 6))
    x = rng.normal(size=(3, 4))
    y = np.asarray(op(jnp.asarray(x.flatten(order="F")), 1))
    np.testing.assert_allclose(
        y, np.asarray(A(jnp.asarray(x))).flatten(order="F"), rtol=1e-12
    )
    z = rng.normal(size=(3, 6))
    w = np.asarray(op(jnp.asarray(z.flatten(order="F")), 2))
    np.testing.assert_allclose(
        w, np.asarray(AT(jnp.asarray(z))).flatten(order="F"), rtol=1e-12
    )
    # adjoint identity through the flat interface
    lhs = float(jnp.vdot(jnp.asarray(z.flatten(order="F")), op(jnp.asarray(x.flatten(order="F")), 1)))
    rhs = float(jnp.vdot(op(jnp.asarray(z.flatten(order="F")), 2), jnp.asarray(x.flatten(order="F"))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_ensure():
    ensure(True)
    try:
        ensure(False, "boom")
    except AssertionError as e:
        assert "boom" in str(e)
    else:
        raise AssertionError("ensure(False) did not raise")
