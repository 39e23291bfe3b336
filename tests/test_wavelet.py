"""TI-Haar frame: perfect reconstruction, tightness, adjointness."""
import jax.numpy as jnp
import numpy as np
import pytest

from semiblind_tv.ops.wavelet import (
    ti_haar_analysis,
    ti_haar_synthesis,
    uniform_blur_kernel,
)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_perfect_reconstruction(rng, levels):
    x = rng.standard_normal((32, 32))
    z = ti_haar_analysis(jnp.asarray(x), levels)
    assert z.shape == (32, 32 * (3 * levels + 1))
    xr = ti_haar_synthesis(z, levels)
    np.testing.assert_allclose(xr, x, rtol=1e-10, atol=1e-12)


def test_adjointness(rng):
    levels = 3
    x = rng.standard_normal((16, 16))
    z = rng.standard_normal((16, 16 * (3 * levels + 1)))
    lhs = float(jnp.sum(ti_haar_analysis(jnp.asarray(x), levels) * z))
    rhs = float(jnp.sum(jnp.asarray(x) * ti_haar_synthesis(jnp.asarray(z), levels)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_parseval(rng):
    x = rng.standard_normal((16, 16))
    z = ti_haar_analysis(jnp.asarray(x), 4)
    np.testing.assert_allclose(float(jnp.sum(z * z)), np.sum(x * x), rtol=1e-10)


def test_uniform_blur_kernel():
    k = uniform_blur_kernel(16, 9)
    assert np.isclose(k.sum(), 1.0)
    # centered circularly: mass is at corners/top rows (kernel peak wraps 0)
    h = np.zeros(16); h[:9] = 1 / 9.0
    h = np.roll(h, -4)
    np.testing.assert_allclose(k, np.outer(h, h))


def test_daubcqf_reference_values():
    """daubcqf(4) must equal the reference's documented example
    (SALSA/daubcqf.m:19-24) to 4 decimals; daubcqf(2) is Haar."""
    from semiblind_tv.ops.wavelet import daubcqf

    h0, h1 = daubcqf(4)
    np.testing.assert_allclose(h0, [0.4830, 0.8365, 0.2241, -0.1294], atol=1e-4)
    np.testing.assert_allclose(h1, [0.1294, 0.2241, -0.8365, 0.4830], atol=1e-4)
    np.testing.assert_allclose(daubcqf(2)[0], [1 / np.sqrt(2)] * 2, rtol=1e-12)
    # 'max' phase is the time reversal (daubcqf.m:100-102)
    np.testing.assert_allclose(daubcqf(4, "max")[0], h0[::-1], rtol=1e-12)
    with pytest.raises(ValueError):
        daubcqf(5)


def test_daubcqf_mid_phase():
    """'mid' phase (daubcqf.m:92-98): a valid orthonormal CQF with the SAME
    magnitude response as min phase but a (near-)linear-phase root
    selection; equals min for N ≤ 6 (the index algebra picks the in-circle
    roots there) and differs from N = 8 up."""
    from semiblind_tv.ops.wavelet import daubcqf

    def phase_nonlinearity(h):
        w = np.linspace(0.01, np.pi * 0.9, 256)
        H = np.array([np.sum(h * np.exp(-1j * wi * np.arange(len(h)))) for wi in w])
        ph = np.unwrap(np.angle(H))
        A = np.vstack([w, np.ones_like(w)]).T
        res = ph - A @ np.linalg.lstsq(A, ph, rcond=None)[0]
        return np.abs(res).max()

    np.testing.assert_allclose(daubcqf(4, "mid")[0], daubcqf(4, "min")[0], rtol=1e-12)
    np.testing.assert_allclose(daubcqf(6, "mid")[0], daubcqf(6, "min")[0], rtol=1e-12)
    for N in (8, 10, 16):
        h0m, _ = daubcqf(N, "min")
        h0d, h1d = daubcqf(N, "mid")
        assert not np.allclose(h0d, h0m)
        assert h0d.sum() == pytest.approx(np.sqrt(2.0), rel=1e-10)
        assert (h0d**2).sum() == pytest.approx(1.0, rel=1e-8)
        for m in range(1, N // 2):
            assert np.dot(h0d[: -2 * m], h0d[2 * m :]) == pytest.approx(0.0, abs=1e-8)
        # same autocorrelation = same |H(w)|; strictly more linear phase
        np.testing.assert_allclose(
            np.convolve(h0d, h0d[::-1]), np.convolve(h0m, h0m[::-1]), atol=1e-8
        )
        assert phase_nonlinearity(h0d) < 0.5 * phase_nonlinearity(h0m)
    with pytest.raises(ValueError):
        daubcqf(8, "median")


@pytest.mark.parametrize("order", [2, 4, 8])
def test_daubcqf_orthonormal_cqf(order):
    """Σh0 = √2, ‖h0‖ = 1, even-shift orthonormality, h1 ⊥ h0 shifts."""
    from semiblind_tv.ops.wavelet import daubcqf

    h0, h1 = daubcqf(order)
    assert h0.sum() == pytest.approx(np.sqrt(2.0), rel=1e-12)
    assert (h0**2).sum() == pytest.approx(1.0, rel=1e-10)
    for m in range(1, order // 2):
        assert np.dot(h0[: -2 * m], h0[2 * m :]) == pytest.approx(0.0, abs=1e-10)
        assert np.dot(h1[: -2 * m], h1[2 * m :]) == pytest.approx(0.0, abs=1e-10)
    assert np.dot(h0, h1) == pytest.approx(0.0, abs=1e-10)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("levels", [1, 3])
def test_general_order_tight_frame(rng, order, levels):
    """W Wᵀ = I to 1e-10 at every order (the Sherman-Morrison requirement of
    the wavelet-L1 SALSA solve) + adjointness of analysis/synthesis."""
    from semiblind_tv.ops.wavelet import ti_analysis, ti_synthesis

    x = rng.standard_normal((32, 32))
    z = ti_analysis(jnp.asarray(x), levels, order)
    assert z.shape == (32, 32 * (3 * levels + 1))
    xr = ti_synthesis(z, levels, order)
    np.testing.assert_allclose(xr, x, rtol=1e-10, atol=1e-10)
    # adjointness <z2, WT x> == <W z2, x>
    z2 = rng.standard_normal(z.shape)
    lhs = float(jnp.sum(ti_analysis(jnp.asarray(x), levels, order) * z2))
    rhs = float(jnp.sum(jnp.asarray(x) * ti_synthesis(jnp.asarray(z2), levels, order)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_wavelet_l1_db4_runs():
    """The L1 experiment accepts a non-Haar filter order end-to-end."""
    import jax

    from semiblind_tv.sapg.wavelet_l1 import WaveletL1Config, run_sapg_wavelet_l1
    from semiblind_tv.utils import synthetic_wheel

    cfg = WaveletL1Config(samples=30, burn_in=10, levels=2, wavelet_order=4,
                          salsa_iters=20)
    res = run_sapg_wavelet_l1(
        synthetic_wheel(32), cfg, jax.random.key(0), dtype=jnp.float64
    )
    assert np.isfinite(res.theta_EB)
    assert np.isfinite(res.mse_db)
