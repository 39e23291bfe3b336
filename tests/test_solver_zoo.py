"""CoRAL and SPGL1 solver-zoo tests."""
import jax.numpy as jnp
import numpy as np

from semiblind_tv.ops import fourier, psf
from semiblind_tv.solvers.coral import coral_tv_l1
from semiblind_tv.solvers.spgl1 import project_l1_ball, spg_lasso, spgl1_bpdn
from tests import oracles

SHAPE = (32, 32)


def _make(rng, sigma=1.0):
    blur = fourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = psf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = blur.otf(k)
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    x = np.kron(rng.random((8, 8)) * 50, np.ones((4, 4)))
    y = oracles.np_blur(x, H_full) + sigma * rng.standard_normal(SHAPE)
    return blur, H, x, y, sigma


# ---------------------------- CoRAL ----------------------------------------

def test_coral_objective_decreases_and_improves(rng):
    blur, H, x, y, _ = _make(rng)
    res = coral_tv_l1(jnp.asarray(y), H, tau_tv=0.3, tau_l1=0.01, blur=blur,
                      mu1=0.03, mu2=0.03, max_iter=150, tol=1e-8,
                      x_true=jnp.asarray(x))
    assert res.objective[res.n_iters] < res.objective[0]
    assert res.mses[res.n_iters - 1] < np.mean((y - x) ** 2)


def test_coral_early_stop(rng):
    blur, H, x, y, _ = _make(rng)
    res = coral_tv_l1(jnp.asarray(y), H, 0.3, 0.01, blur, mu1=0.03, mu2=0.03,
                      max_iter=400, tol=1e-3)
    assert res.n_iters < 400


# ---------------------------- SPGL1 ----------------------------------------

def test_project_l1_ball(rng):
    v = rng.standard_normal((16, 16)) * 5
    for tau in [1.0, 10.0, 1e6]:
        p = np.asarray(project_l1_ball(jnp.asarray(v), tau))
        assert np.sum(np.abs(p)) <= tau * (1 + 1e-8)
    # interior point unchanged
    big = np.asarray(project_l1_ball(jnp.asarray(v), 1e9))
    np.testing.assert_allclose(big, v, rtol=1e-12)
    # projection is the closest point: compare against scipy-style oracle
    tau = 10.0
    p = np.asarray(project_l1_ball(jnp.asarray(v), tau)).ravel()
    u = np.sort(np.abs(v.ravel()))[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, len(u) + 1) > (css - tau))[0][-1]
    theta = (css[rho] - tau) / (rho + 1.0)
    want = np.sign(v.ravel()) * np.maximum(np.abs(v.ravel()) - theta, 0)
    np.testing.assert_allclose(p, want, rtol=1e-9, atol=1e-10)


def test_spg_lasso_respects_ball_and_decreases(rng):
    blur, H, x, y, _ = _make(rng)
    tau = 0.5 * float(np.sum(np.abs(x)))
    xs, resid, g, n = spg_lasso(jnp.asarray(y), H, blur, tau, max_iter=100)
    assert float(jnp.sum(jnp.abs(xs))) <= tau * (1 + 1e-6)
    assert float(resid) < float(np.linalg.norm(y))  # better than x=0


def test_spgl1_bpdn_reaches_sigma(rng):
    blur, H, x, y, sigma = _make(rng, sigma=1.0)
    target = np.sqrt(y.size) * sigma
    res = spgl1_bpdn(jnp.asarray(y), H, blur, sigma=target,
                     max_newton=8, inner_iter=150)
    assert res.resid_norm <= target * 1.2
    assert res.tau > 0
    assert np.all(np.isfinite(res.x))


def test_coral_tv_warm_start(rng):
    """TVINITIALIZATION leg: warm-started duals converge at least as well."""
    blur, H, x, y, _ = _make(rng)
    cold = coral_tv_l1(jnp.asarray(y), H, 0.3, 0.01, blur, mu1=0.03, mu2=0.03,
                       max_iter=150, tol=1e-10, x_true=jnp.asarray(x))
    warm = coral_tv_l1(jnp.asarray(y), H, 0.3, 0.01, blur, mu1=0.03, mu2=0.03,
                       max_iter=150, tol=1e-10, x_true=jnp.asarray(x),
                       tv_warm_start=True)
    assert np.all(np.isfinite(warm.x))
    # same problem, both should land at comparable objectives
    assert abs(warm.objective[-1] - cold.objective[-1]) / cold.objective[-1] < 0.05
    assert warm.mses[warm.n_iters - 1] < np.mean((y - x) ** 2)


def test_salsa_generic_matrix_operator(rng):
    """Generic SALSA with a dense-matrix operator (the reference's matrix-A
    path, SALSA_v2.m:283-300) solving a small L1 problem."""
    from semiblind_tv.solvers.salsa_generic import salsa

    n, m = 48, 96
    Amat = jnp.asarray(rng.standard_normal((n, m)) / np.sqrt(n))
    x_true = np.zeros(m); x_true[rng.choice(m, 6, replace=False)] = rng.standard_normal(6) * 3
    y = Amat @ jnp.asarray(x_true) + 0.01 * jnp.asarray(rng.standard_normal(n))

    mu = 0.1
    # (AᵀA + µI)⁻¹ precomputed densely, like the reference's inverse_term
    inv_term = jnp.linalg.inv(Amat.T @ Amat + mu * jnp.eye(m))
    res = salsa(
        y,
        A=lambda v: Amat @ v,
        AT=lambda v: Amat.T @ v,
        inv_ls=lambda r: inv_term @ r,
        tau=0.02, mu=mu, max_iter=400, tol=1e-10,
    )
    assert res.objective[res.n_iters] <= res.objective[0]
    # support recovery: large entries found
    big = np.abs(x_true) > 1.0
    assert np.corrcoef(res.x[big], x_true[big])[0, 1] > 0.9


def test_salsa_generic_matches_salsa_tv(rng):
    """With the rfft operator + chambolle prox, generic salsa reproduces
    the specialised salsa_tv trajectory."""
    from semiblind_tv.ops.tv import chambolle_prox, tv_norm
    from semiblind_tv.solvers import salsa_tv
    from semiblind_tv.solvers.salsa_generic import salsa

    blur, H, x, y = __import__("tests.test_salsa", fromlist=["x"])._make_problem(rng)
    Hh = np.asarray(H)
    tau, mu = 0.15, 0.015
    inv_f = 1.0 / (np.abs(Hh) ** 2 + mu)

    def prox(v, t):
        f, _ = chambolle_prox(v, t, 10)
        return f

    res_g = salsa(
        jnp.asarray(y),
        A=lambda v: blur.irfft(Hh * jnp.fft.rfft2(v)),
        AT=lambda v: blur.irfft(np.conj(Hh) * jnp.fft.rfft2(v)),
        inv_ls=lambda r: blur.irfft(inv_f * jnp.fft.rfft2(r)),
        tau=tau, mu=mu, prox=prox, phi=tv_norm, max_iter=25, tol=1e-12,
    )
    res_tv = salsa_tv(jnp.asarray(y), H, tau, mu, blur, max_iter=25, tol=1e-12,
                      tv_iters=10)
    # same ADMM up to the prox warm-start difference: generic salsa has NO
    # dual warm start (reference default), so compare against a cold run —
    # objectives agree at iteration 1 and stay within a few percent after
    np.testing.assert_allclose(res_g.objective[1], res_tv.objective[1], rtol=0.02)
    assert abs(res_g.objective[-1] - res_tv.objective[-1]) / res_tv.objective[-1] < 0.05


def test_salsa_v1_inner_iters_denoising(rng):
    """SALSA v1 (SALSA/SALSA.m:476-502): with A = I the fixed point of the
    split is the prox itself — x* = soft(y, tau) as mu-ADMM converges; more
    inner iterations converge in fewer outer iterations."""
    from semiblind_tv.solvers.salsa_generic import salsa_v1

    y = jnp.asarray(rng.standard_normal(64) * 2.0)
    tau, mu = 0.5, 0.5
    ident = lambda v: v
    inv_ls = lambda r: r / (1.0 + mu)
    want = np.sign(np.asarray(y)) * np.maximum(np.abs(np.asarray(y)) - tau, 0.0)

    res1 = salsa_v1(y, ident, ident, inv_ls, tau, mu, max_iter=300, tol=1e-14)
    np.testing.assert_allclose(res1.x, want, atol=1e-6)

    res3 = salsa_v1(y, ident, ident, inv_ls, tau, mu, inner_iters=3,
                    max_iter=300, tol=1e-14)
    np.testing.assert_allclose(res3.x, want, atol=1e-6)

    resz = salsa_v1(y, ident, ident, inv_ls, tau, mu, max_iter=300, tol=1e-14,
                    output="z")
    np.testing.assert_allclose(resz.x, want, atol=1e-6)


def test_salsa_v1_matches_v2_at_one_inner_iter(rng):
    """With identity P and inner_iters=1 the v1 splitting is the same
    recursion as v2 (prox(x−b) → LS → dual update) — trajectories agree."""
    from semiblind_tv.solvers.salsa_generic import salsa, salsa_v1

    n, m = 32, 64
    Amat = jnp.asarray(rng.standard_normal((n, m)) / np.sqrt(n))
    y = jnp.asarray(rng.standard_normal(n))
    mu = 0.2
    inv_term = jnp.linalg.inv(Amat.T @ Amat + mu * jnp.eye(m))
    kw = dict(
        A=lambda v: Amat @ v, AT=lambda v: Amat.T @ v,
        inv_ls=lambda r: inv_term @ r, tau=0.05, mu=mu,
        max_iter=40, tol=0.0,  # no early stop: compare raw trajectories
    )
    res_v2 = salsa(y, **kw)
    res_v1 = salsa_v1(y, **kw)
    np.testing.assert_allclose(res_v1.x, res_v2.x, rtol=1e-8, atol=1e-10)


# ------------------- SPGL1 weighted-norm surface (spgl1_v0.m) ---------------

def test_weighted_l1_projection_exact(rng):
    """Sort-based weighted projection vs a brute-force bisection oracle,
    and w=1 reduction to the unweighted projection."""
    from semiblind_tv.solvers.spgl1 import project_weighted_l1_ball

    v = rng.standard_normal(40) * 3.0
    w = rng.random(40) + 0.2
    tau = 5.0
    out = np.asarray(project_weighted_l1_ball(jnp.asarray(v), tau, jnp.asarray(w)))
    # oracle: bisect theta in sum_i w_i max(|v_i| - theta w_i, 0) = tau
    lo, hi = 0.0, float(np.max(np.abs(v) / w)) + 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        s = np.sum(w * np.maximum(np.abs(v) - mid * w, 0.0))
        lo, hi = (lo, mid) if s <= tau else (mid, hi)
    ref = np.sign(v) * np.maximum(np.abs(v) - hi * w, 0.0)
    np.testing.assert_allclose(out, ref, atol=1e-8)
    assert np.sum(w * np.abs(out)) <= tau * (1 + 1e-10)
    # w == 1 equals the unweighted projection
    ones = jnp.ones(40)
    np.testing.assert_allclose(
        project_weighted_l1_ball(jnp.asarray(v), tau, ones),
        project_l1_ball(jnp.asarray(v), tau),
        atol=1e-12,
    )


def test_weighted_bpdn_dense_oracle_kkt(rng):
    """Weighted BPDN on a dense matrix, verified against the problem's own
    optimality conditions (the cvx-style certificate): at the solution of
    min ‖Wx‖₁ s.t. ‖Ax−b‖ ≤ σ, the residual is on the σ-ball and the dual
    vector z = Aᵀr satisfies |z_i| ≤ λ w_i with equality (and matching
    sign) on the support, λ = ‖W⁻¹z‖_∞."""
    m, n = 30, 80
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    idx = rng.choice(n, 6, replace=False)
    x_true[idx] = rng.standard_normal(6) * 3.0
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    sigma = 0.05
    w = rng.random(n) + 0.5

    Aj = jnp.asarray(A)
    ops = (lambda x: Aj @ x, lambda r: Aj.T @ r)
    res = spgl1_bpdn(
        jnp.asarray(b), None, None, sigma=sigma,
        weights=jnp.asarray(w), A_ops=ops,
        max_newton=20, inner_iter=500, tol=1e-4,
    )
    x = res.x
    r = b - A @ x
    # primal feasibility: residual lands on the sigma-ball
    assert abs(np.linalg.norm(r) - sigma) / sigma < 2e-2
    z = A.T @ r
    lam = np.max(np.abs(z) / w)
    on = np.abs(x) > 1e-6
    assert on.any()
    # stationarity on the support: z_i = lam * w_i * sign(x_i)
    np.testing.assert_allclose(
        z[on], lam * w[on] * np.sign(x[on]), rtol=0, atol=2e-2 * lam
    )
    # dual feasibility off the support comes from the lam definition
    assert np.all(np.abs(z[~on]) <= lam * w[~on] + 1e-10)


def test_weighted_bpdn_weights_reshape_solution(rng):
    """Heavier weight on a coordinate suppresses it relative to the
    unweighted solve (the purpose of the weighted surface)."""
    m, n = 25, 50
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[[3, 17, 31]] = [4.0, -3.0, 2.5]
    b = A @ x_true
    sigma = 1e-3 * np.linalg.norm(b)
    Aj = jnp.asarray(A)
    ops = (lambda x: Aj @ x, lambda r: Aj.T @ r)

    res_plain = spgl1_bpdn(jnp.asarray(b), None, None, sigma=sigma,
                           A_ops=ops, max_newton=20, inner_iter=500)
    w = np.ones(n)
    w[3] = 50.0  # make coordinate 3 expensive
    res_w = spgl1_bpdn(jnp.asarray(b), None, None, sigma=sigma,
                       weights=jnp.asarray(w), A_ops=ops,
                       max_newton=20, inner_iter=500)
    assert abs(res_plain.x[3]) > 1.0          # found by the plain solve
    assert abs(res_w.x[3]) < abs(res_plain.x[3]) * 0.5  # suppressed by weight


def test_complex_bpdn_dense_oracle_kkt(rng):
    """Complex-data BPDN (spgl1_v0.m's complex surface): modulus one-norm,
    phase-preserving soft threshold, conjugate-transpose adjoint.  Verified
    against the complex KKT certificate: on the support the dual vector
    z = Aᴴr aligns with the coefficient phase, z_i = lam·w_i·x_i/|x_i|."""
    m, n = 40, 100
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    x_true = np.zeros(n, complex)
    idx = rng.choice(n, 5, replace=False)
    x_true[idx] = (rng.standard_normal(5) + 1j * rng.standard_normal(5)) * 3.0
    b = A @ x_true + 0.01 * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    sigma = 0.05

    Aj = jnp.asarray(A)
    ops = (lambda x: Aj @ x, lambda r: Aj.conj().T @ r)
    res = spgl1_bpdn(
        jnp.asarray(b), None, None, sigma=sigma, A_ops=ops,
        max_newton=20, inner_iter=500, tol=1e-4,
    )
    x = res.x
    assert np.iscomplexobj(x)
    r = b - A @ x
    assert abs(np.linalg.norm(r) - sigma) / sigma < 2e-2
    z = A.conj().T @ r
    lam = np.max(np.abs(z))
    on = np.abs(x) > 1e-6
    assert on.any()
    np.testing.assert_allclose(
        z[on], lam * x[on] / np.abs(x[on]), rtol=0, atol=3e-2 * lam
    )
    # the planted support is recovered
    assert set(idx) <= set(np.flatnonzero(np.abs(x) > 1e-3))


def test_subspace_minimization_refines_lasso(rng):
    """subspace_min (reference options.subspaceMin, spgl1_v0.m:494-549):
    once the active set stabilizes, the CGLS face refinement must (a) stay
    on the L1 ball, (b) not degrade the objective at a matched iteration
    budget, and (c) typically reach a lower objective in fewer iterations
    on a well-conditioned sparse problem."""
    from semiblind_tv.solvers.spgl1 import project_l1_ball

    m, n = 60, 120
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    idx = rng.choice(n, 5, replace=False)
    x_true[idx] = rng.standard_normal(5) * 2.0
    b = A @ x_true + 0.005 * rng.standard_normal(m)
    tau = 0.9 * np.sum(np.abs(x_true))

    Aj = jnp.asarray(A)
    ops = (lambda x: Aj @ x, lambda r: Aj.T @ r)

    x_plain, r_plain, _, _ = spg_lasso(
        jnp.asarray(b), None, None, tau, max_iter=120, A_ops=ops
    )
    x_sub, r_sub, _, _ = spg_lasso(
        jnp.asarray(b), None, None, tau, max_iter=120, A_ops=ops,
        subspace_min=True,
    )
    # feasibility
    assert float(jnp.sum(jnp.abs(x_sub))) <= tau * (1 + 1e-6)
    # no degradation; allow tiny slack for the different iterate path
    assert float(r_sub) <= float(r_plain) * 1.02
    # the refined run should essentially solve the face least-squares:
    # residual close to the best achievable on the true support
    xs = np.linalg.lstsq(A[:, idx], b, rcond=None)[0]
    proj = project_l1_ball(jnp.zeros(n).at[jnp.asarray(idx)].set(jnp.asarray(xs)), tau)
    r_best = np.linalg.norm(b - A @ np.asarray(proj))
    assert float(r_sub) <= r_best * 1.35
