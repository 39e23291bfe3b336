"""Native C++ kernels vs the NumPy oracle and the JAX path."""
import numpy as np
import pytest

from semiblind_tv import native
from tests import oracles

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_tv_norm_native(rng):
    x = rng.standard_normal((33, 17))
    np.testing.assert_allclose(native.tv_norm_native(x), oracles.np_tv(x), rtol=1e-12)


@pytest.mark.parametrize("lam,iters", [(0.5, 25), (5.0, 10)])
def test_chambolle_native_matches_oracle(rng, lam, iters):
    g = 10 * rng.standard_normal((24, 24))
    f, px, py, k, err = native.chambolle_prox_native(g, lam, iters)
    of, opx, opy, ok, oerr = oracles.np_chambolle(g, lam, iters)
    np.testing.assert_allclose(f, of, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(px, opx, rtol=1e-12, atol=1e-12)
    assert k == ok
    np.testing.assert_allclose(err, oerr, rtol=1e-10)


def test_chambolle_native_warm_start(rng):
    g = 5 * rng.standard_normal((16, 16))
    _, px1, py1, _, _ = native.chambolle_prox_native(g, 1.0, 10)
    f2, _, _, _, _ = native.chambolle_prox_native(g, 1.0, 10, duals=(px1, py1))
    _, opx, opy, _, _ = oracles.np_chambolle(g, 1.0, 10)
    of2, _, _, _, _ = oracles.np_chambolle(g, 1.0, 10, duals=(opx, opy))
    np.testing.assert_allclose(f2, of2, rtol=1e-12, atol=1e-12)


def test_chambolle_native_vs_jax(rng):
    import jax.numpy as jnp

    from semiblind_tv.ops.tv import chambolle_prox

    g = 10 * rng.standard_normal((32, 32))
    f_n, _, _, k_n, _ = native.chambolle_prox_native(g, 0.7, 25)
    f_j, st = chambolle_prox(jnp.asarray(g), 0.7, 25)
    np.testing.assert_allclose(f_n, f_j, rtol=1e-9, atol=1e-10)
    assert k_n == int(st.iters)
