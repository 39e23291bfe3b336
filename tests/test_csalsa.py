"""Constrained SALSA vs a NumPy oracle of the reference loop."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from semiblind_tv.solvers.csalsa import csalsa, csalsa_synthesis, csalsa_tv
from tests import oracles

SHAPE = (32, 32)


def _np_csalsa(y, H, mu1, mu2, eps, delta, max_iter, tol, tv_iters, stop_criterion=1):
    """CSALSA_v2.m:462-545 with TV initialization, x0 = 0."""
    A = lambda v: oracles.np_blur(v, H)
    AT = lambda v: oracles.np_blur_adj(v, H)
    absH2 = np.abs(H) ** 2
    x = np.zeros_like(y)
    u = np.zeros_like(y); bu = np.zeros_like(y)
    v = np.zeros_like(y); bv = np.zeros_like(y)
    pux = np.zeros_like(y); puy = np.zeros_like(y)
    prev_obj = oracles.np_tv(x)
    prev_crit = np.linalg.norm(A(x) - y)
    n = 0
    for k in range(max_iter):
        r = mu1 * (u + bu) + mu2 * AT(y + v + bv)
        x_new = np.real(np.fft.ifft2(np.fft.fft2(r) / (mu2 * absH2 + mu1)))
        u, pux, puy, _, _ = oracles.np_chambolle(
            x_new - bu, 1.0 / mu1, tv_iters, duals=(pux, puy)
        )
        Ax = A(x_new)
        ve = Ax - y - bv
        n_ve = np.linalg.norm(ve)
        v = ve if n_ve <= eps else ve / n_ve * eps
        bv = bv - (Ax - y - v)
        bu = bu - (x_new - u)
        crit = np.linalg.norm(Ax - y)
        obj = oracles.np_tv(x_new)
        xprev, x = x, x_new
        n += 1
        if k >= 1:
            if stop_criterion == 1:
                sc = abs(obj - prev_obj) / obj
            if sc < tol and crit <= eps:
                mu1 *= delta; mu2 *= delta
                prev_obj, prev_crit = obj, crit
                break
        mu1 *= delta; mu2 *= delta
        prev_obj, prev_crit = obj, crit
    return x, prev_obj, prev_crit, n


def _make(rng):
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = blur.otf(k)
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    x = np.kron(rng.random((8, 8)) * 100, np.ones((4, 4)))
    sigma = 1.0
    y = oracles.np_blur(x, H_full) + sigma * rng.standard_normal(SHAPE)
    return blur, H, H_full, x, y, sigma


def test_csalsa_matches_oracle(rng):
    blur, H, H_full, x, y, sigma = _make(rng)
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    res = csalsa_tv(jnp.asarray(y), H, mu1=0.05, mu2=1.0, blur=blur,
                    epsilon=eps, max_iter=30, tol=1e-12, tv_iters=10)
    ox, oobj, ocrit, on = _np_csalsa(y, H_full, 0.05, 1.0, eps, 1.0, 30, 1e-12, 10)
    np.testing.assert_allclose(res.x, ox, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(res.objective[-1], oobj, rtol=1e-8)
    np.testing.assert_allclose(res.criterion[-1], ocrit, rtol=1e-8)
    assert res.n_iters == on


def test_csalsa_constraint_and_improvement(rng):
    blur, H, H_full, x, y, sigma = _make(rng)
    res = csalsa_tv(jnp.asarray(y), H, mu1=0.05, mu2=1.0, blur=blur,
                    sigma=sigma, max_iter=300, tol=1e-5, x_true=jnp.asarray(x))
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    assert res.criterion[res.n_iters - 1] <= eps * 1.05
    assert res.mses[res.n_iters - 1] < np.mean((y - x) ** 2)


def test_csalsa_default_epsilon_requires_sigma(rng):
    blur, H, _, _, y, _ = _make(rng)
    import pytest

    with pytest.raises(ValueError):
        csalsa_tv(jnp.asarray(y), H, 0.05, 1.0, blur)


# ---------------------------------------------------------------------------
# Generic surface (CSALSA_v2.m:88-137 options) vs oracles.np_csalsa_generic
# ---------------------------------------------------------------------------

def _generic_ops(blur, H, H_full):
    """Matched (jnp, np) operator triples for the FFT-diagonal blur."""
    Hj = jnp.asarray(np.asarray(H))
    A = lambda v: blur.irfft(Hj * blur.rfft(v))
    AT = lambda v: blur.irfft(jnp.conj(Hj) * blur.rfft(v))
    absH2 = jnp.abs(Hj) ** 2
    invLS = lambda r, m1, m2: blur.irfft(blur.rfft(r) / (m2 * absH2 + m1))

    nA = lambda v: oracles.np_blur(v, H_full)
    nAT = lambda v: oracles.np_blur_adj(v, H_full)
    nabsH2 = np.abs(H_full) ** 2
    nLS = lambda r, m1, m2: np.real(
        np.fft.ifft2(np.fft.fft2(r) / (m2 * nabsH2 + m1))
    )
    return (A, AT, invLS), (nA, nAT, nLS)


def test_csalsa_generic_default_soft_matches_oracle(rng):
    blur, H, H_full, x, y, sigma = _make(rng)
    (A, AT, invLS), (nA, nAT, nLS) = _generic_ops(blur, H, H_full)
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    res = csalsa(jnp.asarray(y), A, AT, invLS, 0.05, 1.0,
                 epsilon=eps, max_iter=25, tol=1e-4, delta=1.05)
    orc = oracles.np_csalsa_generic(y, nA, nAT, nLS, 0.05, 1.0, eps,
                                    max_iter=25, tol=1e-4, delta=1.05)
    assert res.n_iters == orc["n_iters"]
    n = res.n_iters
    np.testing.assert_allclose(res.x, orc["x"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(res.objective[:n], orc["objective"][:n], rtol=1e-8)
    np.testing.assert_allclose(res.criterion[:n], orc["criterion"][:n], rtol=1e-8)
    np.testing.assert_allclose(res.distance1[:n], orc["distance1"][:n], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(res.distance2[:n], orc["distance2"][:n], rtol=1e-7, atol=1e-9)


def test_csalsa_generic_custom_psi_phi_matches_oracle(rng):
    """Caller Psi/Phi pair ('Psi'/'Phi' options): quadratic regularizer with
    prox v/(1+tau)."""
    blur, H, H_full, x, y, sigma = _make(rng)
    (A, AT, invLS), (nA, nAT, nLS) = _generic_ops(blur, H, H_full)
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    res = csalsa(jnp.asarray(y), A, AT, invLS, 0.05, 1.0, epsilon=eps,
                 prox=lambda v, tau: v / (1.0 + tau),
                 phi=lambda v: 0.5 * jnp.sum(v * v),
                 max_iter=20, tol=1e-12, stop_criterion=2)
    orc = oracles.np_csalsa_generic(
        y, nA, nAT, nLS, 0.05, 1.0, eps,
        psi=lambda v, tau: v / (1.0 + tau), phi=lambda v: 0.5 * np.sum(v * v),
        max_iter=20, tol=1e-12, stop_criterion=2)
    np.testing.assert_allclose(res.x, orc["x"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(res.objective[:20], orc["objective"], rtol=1e-8)


def test_csalsa_generic_analysis_pair_matches_oracle(rng):
    """P/PT analysis option: an exactly orthogonal P (PPᵀ = I) on the
    flattened image, soft-threshold prox in the transform domain."""
    blur, H, H_full, x, y, sigma = _make(rng)
    (A, AT, invLS), (nA, nAT, nLS) = _generic_ops(blur, H, H_full)
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    Q, _ = np.linalg.qr(rng.standard_normal((y.size, y.size)))
    Pj = lambda c: (jnp.asarray(Q) @ c.ravel()).reshape(y.shape)
    PTj = lambda v: jnp.asarray(Q).T @ v.ravel()
    Pn = lambda c: (Q @ np.ravel(c)).reshape(y.shape)
    PTn = lambda v: Q.T @ np.ravel(v)
    res = csalsa(jnp.asarray(y), A, AT, invLS, 0.05, 1.0, epsilon=eps,
                 P=Pj, PT=PTj, max_iter=15, tol=1e-12)
    orc = oracles.np_csalsa_generic(y, nA, nAT, nLS, 0.05, 1.0, eps,
                                    P=Pn, PT=PTn, max_iter=15, tol=1e-12)
    np.testing.assert_allclose(res.x, orc["x"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res.distance2[:15], orc["distance2"], rtol=1e-6, atol=1e-9)


def test_csalsa_generic_tv_init_matches_tv_specialisation(rng):
    """'TVINITIALIZATION' mode of the generic loop ≡ the fused csalsa_tv."""
    blur, H, H_full, x, y, sigma = _make(rng)
    (A, AT, invLS), _ = _generic_ops(blur, H, H_full)
    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    res_g = csalsa(jnp.asarray(y), A, AT, invLS, 0.05, 1.0, epsilon=eps,
                   tv_init=True, tv_iters=10, max_iter=20, tol=1e-14)
    res_tv = csalsa_tv(jnp.asarray(y), H, mu1=0.05, mu2=1.0, blur=blur,
                       epsilon=eps, max_iter=20, tol=1e-14, tv_iters=10)
    np.testing.assert_allclose(res_g.x, res_tv.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res_g.objective, res_tv.objective, rtol=1e-9)


def test_csalsa_synthesis_frame(rng):
    """csalsa.m synthesis-frame path: Woodbury LS identity + constrained
    recovery through a Parseval TI Haar frame."""
    from semiblind_tv.ops.wavelet import ti_analysis, ti_synthesis

    blur, H, H_full, x, y, sigma = _make(rng)
    levels = 1
    W = lambda s: ti_synthesis(s, levels)
    WT = lambda v: ti_analysis(v, levels)
    Hj = jnp.asarray(np.asarray(H))

    # Woodbury identity: (mu1 I + mu2 W^T A^T A W) @ invLS(r) == r
    mu1, mu2 = 0.3, 1.0
    absH2 = np.abs(np.asarray(H)) ** 2
    filt = absH2 / (absH2 + mu1 / mu2)
    s = jnp.asarray(WT(jnp.asarray(rng.standard_normal(SHAPE))))
    invLS = lambda r: (r - WT(blur.irfft(jnp.asarray(filt) * blur.rfft(W(r))))) / mu1
    z = invLS(s)
    AW = lambda c: blur.irfft(Hj * blur.rfft(W(c)))
    WTAT = lambda v: WT(blur.irfft(jnp.conj(Hj) * blur.rfft(v)))
    lhs = mu1 * z + mu2 * WTAT(AW(z))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(s), rtol=1e-9, atol=1e-9)

    eps = float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)
    res = csalsa_synthesis(jnp.asarray(y), H, blur, W, WT, mu1, mu2,
                           epsilon=eps, max_iter=120, tol=1e-4)
    img = np.asarray(W(jnp.asarray(res.x)))
    assert res.criterion[res.n_iters - 1] <= eps * 1.05
    assert np.mean((img - x) ** 2) < np.mean((y - x) ** 2)
